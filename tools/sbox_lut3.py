#!/usr/bin/env python3
"""Cover Boyar & Peralta's AES S-box circuit with the fewest three-input
gates, and print it as the body of ``sub_bytes`` in
``src/repro_torch/kernels/garble/csrc/aes_ct.cuh``.

    python3 tools/sbox_lut3.py

The card's LOP3 instruction computes any boolean function of three 32-bit
words.  Each gate of the 128-gate depth-16 circuit (Boyar & Peralta,
"A depth-16 circuit for the AES S-box", 2012) can absorb the gates below
it as long as its inputs number at most three: the cuts of the circuit.
An integer program (scipy's ``milp``) picks one cut for each gate that is
kept, such that every output is kept and every cut's inputs are circuit
inputs or kept gates, with as few gates kept as possible.  The affine
constant 0x63 (the circuit's four XNORs) is left out: the round keys carry
it.  Each kept gate keeps its name in the circuit.
"""

import re

import numpy as np

# the circuit: U0 is the most significant input bit, S0 the most
# significant output bit; the XNORs of S1, S2, S6 and S7 written as XORs
CIRCUIT = """
T1=U0^U3 T2=U0^U5 T3=U0^U6 T4=U3^U5 T5=U4^U6 T6=T1^T5 T7=U1^U2 T8=U7^T6
T9=U7^T7 T10=T6^T7 T11=U1^U5 T12=U2^U5 T13=T3^T4 T14=T6^T11 T15=T5^T11
T16=T5^T12 T17=T9^T16 T18=U3^U7 T19=T7^T18 T20=T1^T19 T21=U6^U7
T22=T7^T21 T23=T2^T22 T24=T2^T10 T25=T20^T17 T26=T3^T16 T27=T1^T12
M1=T13&T6 M2=T23&T8 M3=T14^M1 M4=T19&U7 M5=M4^M1 M6=T3&T16 M7=T22&T9
M8=T26^M6 M9=T20&T17 M10=M9^M6 M11=T1&T15 M12=T4&T27 M13=M12^M11
M14=T2&T10 M15=M14^M11 M16=M3^M2 M17=M5^T24 M18=M8^M7 M19=M10^M15
M20=M16^M13 M21=M17^M15 M22=M18^M13 M23=M19^T25 M24=M22^M23 M25=M22&M20
M26=M21^M25 M27=M20^M21 M28=M23^M25 M29=M28&M27 M30=M26&M24 M31=M20&M23
M32=M27&M31 M33=M27^M25 M34=M21&M22 M35=M24&M34 M36=M24^M25 M37=M21^M29
M38=M32^M33 M39=M23^M30 M40=M35^M36 M41=M38^M40 M42=M37^M39 M43=M37^M38
M44=M39^M40 M45=M42^M41 M46=M44&T6 M47=M40&T8 M48=M39&U7 M49=M43&T16
M50=M38&T9 M51=M37&T17 M52=M42&T15 M53=M45&T27 M54=M41&T10 M55=M44&T13
M56=M40&T23 M57=M39&T19 M58=M43&T3 M59=M38&T22 M60=M37&T20 M61=M42&T1
M62=M45&T4 M63=M41&T2 L0=M61^M62 L1=M50^M56 L2=M46^M48 L3=M47^M55
L4=M54^M58 L5=M49^M61 L6=M62^L5 L7=M46^L3 L8=M51^M59 L9=M52^M53
L10=M53^L4 L11=M60^L2 L12=M48^M51 L13=M50^L0 L14=M52^M61 L15=M55^L1
L16=M56^L0 L17=M57^L1 L18=M58^L8 L19=M63^L4 L20=L0^L1 L21=L1^L7
L22=L3^L12 L23=L18^L2 L24=L15^L9 L25=L6^L10 L26=L7^L9 L27=L8^L10
L28=L11^L14 L29=L11^L17 S0=L6^L24 S1=L16^L26 S2=L19^L28 S3=L6^L21
S4=L20^L22 S5=L25^L29 S6=L13^L27 S7=L6^L23
"""
GATES = {m[0]: (m[1], m[2], m[3]) for m in
         re.findall(r"(\w+)=(\w+)([\^&])(\w+)", CIRCUIT)}
INPUTS = [f"U{i}" for i in range(8)]
OUTPUTS = [f"S{i}" for i in range(8)]


def cuts(k: int = 3) -> dict:
    """Every gate's cuts of at most k inputs, the trivial one last."""
    out = {u: [frozenset([u])] for u in INPUTS}
    for g, (a, _, b) in GATES.items():
        cs = {x | y for x in out[a] for y in out[b] if len(x | y) <= k}
        out[g] = [c for c in cs if not any(d < c for d in cs)] + \
            [frozenset([g])]
    return out


def cover() -> dict:
    """gate -> its chosen cut, for the gates that are kept."""
    from scipy.optimize import Bounds, LinearConstraint, milp
    cs = cuts()
    var = [(g, None) for g in GATES] + [(g, c) for g in GATES
                                        for c in cs[g][:-1]]
    col = {v: i for i, v in enumerate(var)}
    rows, lo, hi = [], [], []

    def row(terms, low, high):
        r = np.zeros(len(var))
        for v, w in terms:
            r[col[v]] += w
        rows.append(r)
        lo.append(low)
        hi.append(high)

    for g in GATES:   # a kept gate takes exactly one cut
        row([((g, None), 1)] + [((g, c), -1) for c in cs[g][:-1]], 0, 0)
        for c in cs[g][:-1]:   # whose inputs are inputs or kept gates
            for leaf in c & GATES.keys():
                row([((leaf, None), 1), ((g, c), -1)], 0, np.inf)
    for s in OUTPUTS:
        row([((s, None), 1)], 1, 1)
    res = milp([1.0 if c is None else 0.0 for _, c in var],
               constraints=LinearConstraint(np.array(rows), lo, hi),
               integrality=np.ones(len(var)), bounds=Bounds(0, 1))
    assert res.status == 0, res.message
    return {g: c for (g, c), x in zip(var, res.x) if c is not None and x > .5}


def _key(name: str):
    return "TMLSU".index(name[0]), int(name[1:])


def truth_table(gate: str, leaves: list) -> int:
    """The gate as a function of its leaves, in LOP3's encoding: the
    leaves take the values 0xF0, 0xCC and 0xAA."""
    env = dict(zip(leaves, (0xF0, 0xCC, 0xAA)))

    def val(n):
        if n not in env:
            a, op, b = GATES[n]
            env[n] = val(a) ^ val(b) if op == "^" else val(a) & val(b)
        return env[n]
    return val(gate) & 0xFF


def emit(chosen: dict) -> str:
    lines = []
    for g in GATES:
        if g not in chosen:
            continue
        leaves = sorted(chosen[g], key=_key)
        lut = truth_table(g, leaves)
        if len(leaves) == 3:
            expr = f"lop3<0x{lut:02X}>({', '.join(leaves)})"
        elif lut == 0xF0 ^ 0xCC:
            expr = f"{leaves[0]} ^ {leaves[1]}"
        elif lut == 0xF0 & 0xCC:
            expr = f"{leaves[0]} & {leaves[1]}"
        else:
            expr = f"lop3<0x{lut:02X}>({leaves[0]}, {leaves[1]}, 0)"
        target = (f"p[{7 - int(g[1:])}]" if g in OUTPUTS
                  else f"const uint32_t {g}")
        lines.append(f"  {target} = {expr};")
    return "\n".join(lines)


if __name__ == "__main__":
    chosen = cover()
    print(f"  // {len(chosen)} gates")
    print(emit(chosen))
