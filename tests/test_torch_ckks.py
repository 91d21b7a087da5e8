"""The port's CKKS against the JAX package's, on the CPU (the plain NTT):
every ``CkksContext`` op at rings 128 and 1024 from the same seed and,
through ``interop.ckks_context_from_keys``, from the reference's keys; the
five CKKS workloads end to end against the reference Session; the main
job's plan at the benchmark width; and a ring the reference cannot run.
Every comparison with the JAX package is bitwise."""

import copy

import numpy as np
import pytest
import torch

from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro.core.bytecode import encode_chunk as ref_encode
from repro.protocols.ckks.cipher import CkksContext as RefContext
from repro.protocols.ckks.params import CkksParams as RefParams
from repro_torch import __main__ as cli
from repro_torch.api import JobSpec, Session
from repro_torch.core.bytecode import encode_chunk
from repro_torch.interop import ckks_context_from_keys
from repro_torch.kernels.ntt import ops as tops
from repro_torch.protocols.ckks import ntt as tntt
from repro_torch.protocols.ckks.cipher import CkksContext
from repro_torch.protocols.ckks.params import CkksParams

SEED = 0xCEC5


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int64))


def _eq(got: torch.Tensor, want: np.ndarray) -> bool:
    return got.shape == want.shape and \
        np.array_equal(got.numpy(), want.astype(np.int64))


def _ref_keys(ref: RefContext) -> dict:
    return {lvl: [(k.b, k.a) for k in keys] for lvl, keys in ref._evk.items()}


@pytest.fixture(scope="module", params=[128, 1024], ids=["ring128",
                                                         "ring1024"])
def contexts(request):
    n = request.param
    ref = RefContext(RefParams(n_ring=n, levels=2), seed=SEED)
    rng_after_keys = copy.deepcopy(ref._rng)
    port = CkksContext(CkksParams(n_ring=n, levels=2), seed=SEED,
                       device="cpu")
    carried = ckks_context_from_keys(CkksParams(n_ring=n, levels=2),
                                     ref.s_int, _ref_keys(ref), device="cpu",
                                     rng=rng_after_keys)
    return ref, port, carried


def _slots(p, k: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, p.slots) for _ in range(k)]


def test_keys_match(contexts):
    ref, port, carried = contexts
    p = ref.p
    chain = p.primes + [p.special_prime]
    for ctx in (port, carried):
        assert np.array_equal(ctx.s_int, ref.s_int)
        for j, q in enumerate(chain):
            assert _eq(ctx._spow[0, j], ref._s_ntt[q])
            assert _eq(ctx._spow[1, j], ref._s2_ntt(q))
        for lvl in range(1, p.levels + 1):
            b, a = ctx.evk(lvl)
            assert _eq(b, np.stack([k.b for k in ref._evk[lvl]]))
            assert _eq(a, np.stack([k.a for k in ref._evk[lvl]]))


def test_every_op_matches(contexts):
    """encode, encrypt, decrypt, decode, add, sub, mul_tensor, relinearize,
    rescale, mul, mul_plain, add_plain: the seeded context and the one
    carried over from the reference's keys both equal the reference."""
    ref0, port, carried = contexts
    p = ref0.p
    L = p.levels
    for ctx in (port, carried):
        # both draw encryptions from where the reference's keys ended
        ref = copy.deepcopy(ref0)
        ctx._rng = copy.deepcopy(ref0._rng)
        x, y, w = _slots(p, 3, p.n_ring)
        pts = [ref.encode(v) for v in (x, y, w)]
        for pt, v in zip(pts, (x, y, w)):
            assert _eq(ctx.encode(v), pt)
        cx, cy = ref.encrypt(pts[0]), ref.encrypt(pts[1])
        tx, ty = ctx.encrypt(_t(pts[0])), ctx.encrypt(_t(pts[1]))
        assert _eq(tx, cx) and _eq(ty, cy)
        tw = _t(pts[2])
        assert _eq(ctx.add(tx, ty, L), ref.add(cx, cy, L))
        assert _eq(ctx.sub(tx, ty, L), ref.sub(cx, cy, L))
        c3 = ref.mul_tensor(cx, cy, L)
        t3 = ctx.mul_tensor(tx, ty, L)
        assert _eq(t3, c3)
        assert _eq(ctx.add(t3, tx, L), ref.add(c3, cx, L))
        assert _eq(ctx.sub(tx, t3, L), ref.sub(cx, c3, L))
        r2 = ref.relinearize(c3, L)
        assert _eq(ctx.relinearize(t3, L), r2)
        assert _eq(ctx.rescale(_t(r2), L), ref.rescale(r2, L))
        m = ref.mul(cx, cy, L)
        assert _eq(ctx.mul(tx, ty, L), m)
        mp = ref.mul_plain(cx, pts[2], L)
        assert _eq(ctx.mul_plain(tx, tw, L), mp)
        assert _eq(ctx.add_plain(_t(m), tw, L - 1),
                   ref.add_plain(m, pts[2], L - 1))
        for ct, lvl in ((cx, L), (c3, L), (m, L - 1), (mp, L - 1)):
            pt = ref.decrypt(ct, lvl)
            got = ctx.decrypt(_t(ct), lvl)
            assert _eq(got, pt)
            assert np.array_equal(ctx.decode(got, lvl, p.scale),
                                  ref.decode(pt, lvl, p.scale))
        assert ctx.counts["ntt_forward"] > 0 and ctx.counts["mul_mod"] > 0


class _Unfused(CkksContext):
    """The five ops that multiply polynomials as three calls each (forward
    transforms, products, inverse transforms, with the gathers and copies
    between them), as the port computed them before the fused product."""

    def _inv(self, a, primes):
        self.counts["ntt_inverse"] += self._rows(a)
        return tntt.ntt_inverse(a, primes)

    def encrypt(self, pt_full):
        p = self.p
        primes = p.primes
        a_int = self._sample_uniform_int(p.n_ring)
        e_int = self._sample_error(p.n_ring)
        q = self.col(primes)
        ae = torch.remainder(self._dev(np.stack([a_int, e_int]))[:, None, :],
                             q)
        aj, ej = ae[0], ae[1]
        as_ = self._inv(self._mul(self._fwd(aj, primes),
                                  self._spow_rows(1, tuple(primes))[0],
                                  primes), primes)
        c0 = (pt_full + ej + (q - as_)) % q
        return torch.stack([c0, aj])

    def decrypt(self, ct, level):
        primes = tuple(self.p.level_primes(level))
        q = self.col(primes)
        acc = ct[0] % q
        k = ct.shape[0] - 1
        if k:
            ck = self._fwd(ct[1:] % q, primes)
            back = self._inv(self._mul(ck, self._spow_rows(k, primes),
                                       primes), primes)
            acc = (acc + back.sum(0)) % q
        return acc

    def mul_tensor(self, c1, c2, level):
        primes = tuple(self.p.level_primes(level))
        q = self.col(primes)
        f = self._fwd(torch.cat([c1, c2], dim=-3) % q, primes)
        lhs = f[..., [0, 0, 1, 1], :, :]
        rhs = f[..., [2, 3, 2, 3], :, :]
        pr = self._mul(lhs, rhs, primes)
        mid = (pr[..., 1, :, :] + pr[..., 2, :, :]) % q
        return self._inv(torch.stack([pr[..., 0, :, :], mid,
                                      pr[..., 3, :, :]], dim=-3), primes)

    def relinearize(self, ct3, level):
        p = self.p
        primes = tuple(p.level_primes(level))
        basis = primes + (p.special_prime,)
        d = len(primes)
        qb = self.col(basis)
        dj = self._fwd(torch.remainder(ct3[2][:, None, :], qb), basis)
        keys = self._evk[level]
        prods = self._mul(dj.expand_as(keys).contiguous(), keys, basis)
        back = self._inv(prods.sum(dim=1) % qb, basis)
        q = self.col(primes)
        dP = back[:, d]
        dP = torch.where(dP > p.special_prime // 2, dP - p.special_prime, dP)
        t = (back[:, :d] + torch.remainder(-dP[:, None, :], q)) % q
        return (ct3[:2] + t * self.inv_col(p.special_prime, primes)) % q

    def mul_plain(self, ct, pt_full, level):
        primes = tuple(self.p.level_primes(level))
        q = self.col(primes)
        k = ct.shape[0]
        f = self._fwd(torch.cat([ct, pt_full[None, :len(primes)]]) % q,
                      primes)
        out = self._inv(self._mul(f[:k], f[k:].expand(k, -1, -1)
                                  .contiguous(), primes), primes)
        return self.rescale(out, level)


@pytest.mark.parametrize("n", [128, 1024])
def test_fused_ops_match_unfused(n):
    """encrypt, decrypt (2 and 3 components), mul_tensor (one and a batch),
    relinearize at both levels and mul_plain through the fused product
    equal the three-call compositions bit for bit, from one seed; and the
    rows each counts are the same but for decrypt's 3-component inverse,
    which now transforms the sum (P rows, not 2 P)."""
    p = CkksParams(n_ring=n, levels=2)
    new = CkksContext(p, seed=SEED, device="cpu")
    old = _Unfused(p, seed=SEED, device="cpu")
    assert torch.equal(new._evk[2], old._evk[2])
    rng = np.random.default_rng(n)
    L = p.levels
    q = np.asarray(p.primes, dtype=np.int64)[:, None]
    pt = _t(rng.integers(0, 1 << 40, (L + 1, n)) % q)
    new.counts.clear()
    old.counts.clear()
    cx = new.encrypt(pt)
    assert torch.equal(cx, old.encrypt(pt))
    cy = _t(rng.integers(0, 1 << 40, (2, L + 1, n)) % q)
    batch = _t(rng.integers(0, 1 << 40, (3, 2, 2, L + 1, n)) % q)
    for lvl in (L, L - 1):
        c1, c2 = cx[:, :lvl + 1], cy[:, :lvl + 1]
        t3 = new.mul_tensor(c1, c2, lvl)
        assert torch.equal(t3, old.mul_tensor(c1, c2, lvl))
        assert torch.equal(new.relinearize(t3, lvl),
                           old.relinearize(t3, lvl))
        assert torch.equal(new.decrypt(t3, lvl), old.decrypt(t3, lvl))
        assert torch.equal(new.decrypt(c1, lvl), old.decrypt(c1, lvl))
        assert torch.equal(new.mul_plain(c1, pt, lvl),
                           old.mul_plain(c1, pt, lvl))
        b1, b2 = batch[:, 0, :, :lvl + 1], batch[:, 1, :, :lvl + 1]
        assert torch.equal(new.mul_tensor(b1, b2, lvl),
                           old.mul_tensor(b1, b2, lvl))
    # decrypt of a 3-component ct at each level: 3 and 2 rows fewer
    assert old.counts["ntt_inverse"] - new.counts["ntt_inverse"] == 3 + 2
    for kind in ("ntt_forward", "mul_mod"):
        assert new.counts[kind] == old.counts[kind]


@pytest.mark.parametrize("levels", [5, 7])
def test_relinearize_deep_levels(levels):
    """relinearize at levels of more digits than one fused launch takes
    (3 D operands, above the kernel's 16 from D = 6): a sum of fused calls
    over parts of the digits equals the three-call composition and the JAX
    package's CkksContext bit for bit, at the top level, the first level
    of one launch and the lowest, from the reference's keys; and from the
    port's own keys it equals the composition over the same keys."""
    n = 128
    ref = RefContext(RefParams(n_ring=n, levels=levels), seed=SEED)
    p = CkksParams(n_ring=n, levels=levels)
    port = ckks_context_from_keys(p, ref.s_int, _ref_keys(ref),
                                  device="cpu")
    own = CkksContext(p, seed=SEED, device="cpu")
    old = _Unfused(p, seed=SEED, device="cpu")
    assert [len(own._relin_keys[lvl]) for lvl in (levels, 4, 1)] == \
        [2, 1, 1]
    rng = np.random.default_rng(levels)
    for lvl in (levels, 4, 1):
        q = np.asarray(p.level_primes(lvl), dtype=np.int64)[:, None]
        ct3 = rng.integers(0, 1 << 40, (3, lvl + 1, n)) % q
        want = ref.relinearize(ct3.astype(np.uint64), lvl)
        assert _eq(port.relinearize(_t(ct3), lvl), want)
        assert torch.equal(own.relinearize(_t(ct3), lvl),
                           old.relinearize(_t(ct3), lvl))


def test_batched_ops_match_one_by_one(contexts):
    """add, sub, mul_tensor and add_plain on a (count, ...) stack, as the
    batched driver calls them, equal the ops one ciphertext at a time."""
    ref, port, _ = contexts
    p = ref.p
    rng = np.random.default_rng(1)
    q = np.asarray(p.primes, dtype=np.int64)[None, None, :, None]
    a = _t(rng.integers(0, 1 << 31, (3, 2, 3, p.n_ring)) % q)
    b = _t(rng.integers(0, 1 << 31, (3, 2, 3, p.n_ring)) % q)
    pt = _t(rng.integers(0, 1 << 31, (3, 3, p.n_ring)) % q[0])
    L = p.levels
    for fn in (port.add, port.sub, port.mul_tensor):
        got = fn(a, b, L)
        for i in range(3):
            assert torch.equal(got[i], fn(a[i], b[i], L))
    got = port.add_plain(a, pt, L)
    for i in range(3):
        assert torch.equal(got[i], port.add_plain(a[i], pt[i], L))


# ---------------------------------------------------------------------------
# Sessions: the five workloads at ring 128 against the reference Session
# ---------------------------------------------------------------------------

#: (workload, n, budget in frames, prefetch pages): every budget swaps
JOBS = [("rmvmul", 4, 3, 1), ("rstats", 8, 4, 1), ("rsum", 64, 4, 1),
        ("n_rmatmul", 4, 4, 1), ("t_rmatmul", 4, 4, 1)]


@pytest.mark.parametrize("wl,n,budget,prefetch", JOBS,
                         ids=[j[0] for j in JOBS])
def test_session_matches_reference(wl, n, budget, prefetch):
    job = dict(n=n, memory_budget=budget, prefetch_pages=prefetch)
    ref = RefSession(RefJobSpec(workload=wl, driver="ckks", **job))
    ref_out = ref.execute(check=True)
    s = Session(JobSpec(wl, **job), device="cpu")
    tops.reset_counts()
    out = s.execute(check=True)
    assert sorted(out) == sorted(ref_out)
    assert all(np.array_equal(out[k], ref_out[k]) for k in ref_out)
    assert np.array_equal(encode_chunk(s.plan()[0].instrs),
                          ref_encode(ref.plan()[0].instrs))
    rr, pr = ref.plan_reports[0].replacement, s.plan_reports[0].replacement
    assert (pr.swap_ins, pr.swap_outs) == (rr.swap_ins, rr.swap_outs)
    assert pr.swap_ins > 0
    e, re_ = s.engine_stats[0], ref.engine_stats[0]
    assert (e.swap_ins, e.io_read_bytes, e.io_write_bytes) == \
        (pr.swap_ins, re_.io_read_bytes, re_.io_write_bytes)
    assert e.instructions == re_.instructions
    # the CPU path ran the plain versions and launched nothing
    c = tops.counts()
    assert sum(c["launches"].values()) == 0
    assert sum(s.ckks_counts.values()) > 0


def test_main_job_plan_matches_reference():
    """rmvmul n=24 at the benchmark width (ring 1024, levels 2), budget 0.4
    of the working set, 8 prefetch pages: plan only."""
    job = dict(n=24, memory_budget=0.4, prefetch_pages=8, lookahead=10_000,
               ckks_ring=1024, ckks_levels=2)
    ref = RefSession(RefJobSpec(workload="rmvmul", driver="ckks", **job))
    s = Session(JobSpec("rmvmul", **job), device="cpu")
    assert s.ckks_params() == CkksParams(n_ring=1024, levels=2)
    assert np.array_equal(encode_chunk(s.plan()[0].instrs),
                          ref_encode(ref.plan()[0].instrs))
    rep = s.plan_reports[0]
    assert (rep.replacement.swap_ins, rep.replacement.swap_outs) == (646, 309)
    assert (s.config.num_frames, s.config.prefetch_pages) == \
        (ref._cfgs[0].num_frames, ref._cfgs[0].prefetch_pages)


def test_ring_1024_job_on_cpu():
    """The reference draws its inputs at 64 slots whatever the ring, so it
    cannot run this job; the port draws at N/2 = 512 and checks against
    the oracle at the reference's tolerance."""
    s = Session(JobSpec("rmvmul", n=4, memory_budget=0.4, prefetch_pages=2,
                        ckks_ring=1024), device="cpu")
    out = s.execute(check=True)
    assert len(out) == 4 and all(v.shape == (512,) for v in out.values())
    c = s.ckks_counts
    # keygen 40, encrypt 6 x 20 inputs, tensor 21 x 16, relin 20 x 4,
    # decrypt 4 x 4 (level 1 outputs)
    assert c["ntt_forward"] + c["ntt_inverse"] == \
        40 + 6 * 20 + 21 * 16 + 20 * 4 + 4 * 4


def test_cli_runs_ckks_without_real(capsys):
    argv = ["exec", "--workload", "rsum", "-n", "4", "--budget", "4",
            "--check", "--device", "cpu"]
    assert cli.main(argv) == 0
    text = capsys.readouterr().out
    assert '"checked": true' in text and '"homomorphic_ops": 3' in text
