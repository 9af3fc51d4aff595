"""Dtype-tiered tolerances: the same gates as the JAX package's
utils/testing.py (fp32 2e-5, bf16 2e-2, fp16 1e-2), keyed on torch dtypes;
and the second gate of the bf16 flash forward (B1)."""

import torch

from tiny_flash_attention_tpu_torch.ops.dims import WIDE_HEAD_DIM
from tiny_flash_attention_tpu_torch.ops.flash import LN2, LOG2E, in_dtype

_ATOL = {
    torch.float32: 2e-5,
    torch.bfloat16: 2e-2,
    torch.float16: 1e-2,
}

# B1's bf16 out and LSE are held twice against the plain version: at the
# dtype gate as it stands, and at the kernel's own rounding point (q
# multiplied by bf16(sm_scale * log2 e) and rounded to bf16, `fold_q`) at
# tighter gates. The bare gate alone lets faults through: over n visible
# columns of N(0, 1) inputs |out| is about sqrt(e / n) (0.017 at n = 8192),
# so a fault that moves a long row's out by less than 2e-2 passes, and the
# fold alone moves the LSE by up to about 1.5e-2, as much as one kv tile of
# 64 dropped (log(64 / 63) = 0.016). At the fold, out is gated row by row:
# the largest error of a row over the largest |out| of that row, at most
# two bf16 ulps of that largest value (the kernel rounds p before the
# division by the row sum, the plain version after it, so either may round
# a value across an ulp); the LSE at BF16_LSE_GATE. Both are set from the
# H100 readings of the sound kernel and of planted faults (PERF.md).
BF16_ROW_GATE = 2.0 ** -6
BF16_LSE_GATE = 1e-4
# Above head_dim 256 (the instance of width 512) the bare out gate gives
# each element one bf16 ulp of its |plain| beyond the dtype gate: the bare
# gate bounds the arithmetic's gap (the plain version does not fold), and
# the bf16 output adds one rounding on top, which at |out| >= 2 is 1.56e-2
# of the 2e-2. At 64 q heads of 512 such elements occur: the H100 read
# 2.344e-2 at |out| about 2 at DeepSeek-V4-Flash's prefill while the
# gates at the fold held (PERF.md). The gates at the fold are unchanged.


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 at each |x| (f32): 2^(e - 7) for |x| in
    [2^e, 2^(e + 1)), the subnormals' 2^-133 at 0."""
    mant, e = torch.frexp(x.float().abs())
    return torch.where(mant == 0, 2.0 ** -133,
                       torch.ldexp(torch.ones_like(mant), e - 8))


def tolerance_for(dtype: torch.dtype) -> float:
    return _ATOL[dtype]


def fold_q(q: torch.Tensor, sm_scale: float) -> tuple[torch.Tensor, float]:
    """(q', scale') such that the plain forward on q' with sm_scale=scale'
    takes the scores at the kernels' rounding point: q' is q times
    sm_scale * log2 e rounded to q's dtype, the product rounded to q's
    dtype again (the TPU kernels' fold, which the CUDA kernels repeat); the
    log2-domain scores q' k^T times ln 2 are the natural-log ones."""
    return (q.float() * in_dtype(sm_scale * LOG2E, q.dtype)).to(q.dtype), LN2


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of a row (the last axis) over the largest |want|
    of that row, the worst row: 0 where a row agrees exactly (an empty row
    included), inf where only `want`'s row is all 0."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    return float(torch.where(err == 0, 0.0, err / scale).max())


def flash_errors(out, lse, ref, ref_lse) -> dict:
    """Out's largest error ("out"), its largest error beyond one bf16 ulp
    of |ref| ("spaced"), its worst row relative to that row's scale
    ("row") and the LSE's largest error ("lse")."""
    err = (out.float() - ref.float()).abs()
    return {"out": float(err.max()),
            "spaced": float((err - bf16_ulp(ref)).max()),
            "row": row_err(out, ref),
            "lse": float((lse.float() - ref_lse.float()).abs().max())}


def flash_gate_ok(errs: dict, dtype: torch.dtype, folded: dict | None,
                  head_dim: int) -> bool:
    """The forward's gate: the dtype gate on out and the LSE against the
    plain version (`errs`; above head_dim 256 in bf16, out's error beyond
    one bf16 ulp of |plain|); for bf16 also, against the plain version at
    the fold (`folded`, required), the row gate and BF16_LSE_GATE."""
    atol = tolerance_for(dtype)
    spaced = dtype == torch.bfloat16 and head_dim > WIDE_HEAD_DIM
    ok = (errs["spaced" if spaced else "out"] <= atol
          and errs["lse"] <= atol)
    if dtype == torch.bfloat16:
        ok = ok and folded["row"] <= BF16_ROW_GATE \
            and folded["lse"] <= BF16_LSE_GATE
    return ok


def flash_gate(out, lse, plain, q, dtype, lens=None):
    """(errs, folded, ok): the forward's (out, lse) against plain(q,
    sm_scale) and, for bf16, against plain(*fold_q(q, sm_scale)), with
    sm_scale head_dim ** -0.5 (flash_errors readings; folded is None for
    other dtypes), and whether they pass flash_gate_ok at q's head_dim.
    `lens`, one length per batch row, restricts both to the rows below
    each length."""
    sm_scale = q.shape[-1] ** -0.5
    refs = [plain(q, sm_scale)]
    if dtype == torch.bfloat16:
        refs.append(plain(*fold_q(q, sm_scale)))
    lens = lens or [q.shape[2]] * q.shape[0]
    readings = []
    for ref, ref_lse in refs:
        errs = {"out": 0.0, "spaced": -1.0, "row": 0.0, "lse": 0.0}
        for bi, n in enumerate(lens):
            got = flash_errors(out[bi, :, :n], lse[bi, :, :n],
                               ref[bi, :, :n], ref_lse[bi, :, :n])
            errs = {key: max(errs[key], got[key]) for key in errs}
        readings.append(errs)
    folded = readings[1] if len(readings) > 1 else None
    return readings[0], folded, flash_gate_ok(readings[0], dtype, folded,
                                              q.shape[-1])
