r"""The attention forward kernels' share of their roofline: each call's
least time, the larger of its :math:`4 B H L_q L_k D` FLOPs at the card's
bf16 peak and its bytes (q, k, v read once, o written once) at its memory
bandwidth, summed over the traced trajectory's calls (the configuration's
`counts`; max-free and exact forms count the same work), over the device
time of the kernels whose names hold these patterns. A pattern that matches
nothing where there is attention work is an error, never a 0."""

from __future__ import annotations

from harness.peaks import FLOPS_PER_S, HBM_BYTES_PER_S

# the port's csrc/attention_fwd.cu: the tensor-core form and the float32 form
PATTERNS = ("attention_fwd_tc_kernel<", "attention_fwd_kernel<")


def read(trace, cell) -> float | None:
    counts = cell.counts
    peak, item = FLOPS_PER_S[cell.config["dtype"]], counts["itemsize"]
    bound = 0.0
    for B, H, Lq, Lk, D in counts["attention"]:
        flops = 4 * B * H * Lq * Lk * D
        nbytes = item * B * H * D * (2 * Lq + 2 * Lk)
        bound += max(flops / peak, nbytes / HBM_BYTES_PER_S)
    bound *= trace.calls
    if not bound:
        return None
    ns, n = trace.time_of(PATTERNS)
    if not n:
        raise LookupError(f"no device operation matches {PATTERNS} in a cell with attention work")
    return 100 * bound / (ns / 1e9)
