"""The port's vectorized GC trace builders (``workloads.fast_trace``)
against the port's own DSL trace and the JAX package's builders.

``build_*_records`` equal the port's FREE-stripped DSL trace and the
reference's ``fast_trace`` record for record (and by
``records_digest``) for merge, sort and mvmul at two sizes each;
``write_*_program`` files decode to the DSL's instructions with its
vspace and read the same in the reference; bad sizes raise."""

import numpy as np
import pytest

from repro.core.bytecode import ProgramFile as RefProgramFile
from repro.workloads import fast_trace as ref_fast
from repro_torch.core.bytecode import encode_chunk, strip_frees
from repro_torch.core.liveness import file_digest, records_digest
from repro_torch.workloads import fast_trace, get

SIZES = [("merge", 64), ("merge", 256), ("sort", 64), ("sort", 256),
         ("mvmul", 32), ("mvmul", 64)]


def _dsl_records(name: str, n: int) -> np.ndarray:
    return encode_chunk(strip_frees(get(name).trace(n, 1)[0].instrs))


@pytest.mark.parametrize("name,n", SIZES)
def test_builder_equals_dsl_trace_and_reference(name, n):
    fast = getattr(fast_trace, f"build_{name}_records")(n)
    ref = getattr(ref_fast, f"build_{name}_records")(n)
    dsl = _dsl_records(name, n)
    assert fast.dtype == np.int64 and fast.shape == dsl.shape
    assert np.array_equal(fast, dsl)
    assert np.array_equal(fast, ref)
    assert records_digest(0, fast, 0) == records_digest(0, dsl, 0)


@pytest.mark.parametrize("name,n", [("merge", 128), ("sort", 64),
                                    ("mvmul", 32)])
def test_written_program_matches_dsl(tmp_path, name, n):
    pf = getattr(fast_trace, f"write_{name}_program")(tmp_path / "p.bc", n)
    prog = get(name).trace(n, 1)[0]
    assert list(pf.iter_instrs()) == strip_frees(prog.instrs)
    assert (pf.vspace_slots, pf.page_shift, pf.phase) == \
        (prog.vspace_slots, prog.page_shift, "virtual")
    assert pf.meta == {"workload": name, "n": n}
    theirs = getattr(ref_fast, f"write_{name}_program")(tmp_path / "r.bc", n)
    assert open(pf.path, "rb").read() == open(theirs.path, "rb").read()
    assert RefProgramFile(pf.path).num_records == len(pf)
    assert file_digest(pf, chunk_instrs=7) == file_digest(pf)


@pytest.mark.parametrize("name,n", [
    ("merge", 48),     # 2n/C not a power of two
    ("merge", 33),     # not a chunk multiple
    ("merge", 0),
    ("sort", 96),      # n/C not a power of two
    ("sort", 0),
    ("mvmul", 24),     # not a block multiple
])
def test_builders_reject_bad_sizes(name, n):
    with pytest.raises(ValueError):
        getattr(fast_trace, f"build_{name}_records")(n)
