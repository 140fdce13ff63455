"""The least time a search could take on the card: the frozen roofline.

Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense rates): 67 TFLOP/s in float32 outside the tensor
cores and 3.35 TB/s of HBM.  The count is the search's work, not a
kernel's, so any implementation of the search reads against the same
bound.
"""

from __future__ import annotations

F32_PEAK = 67e12      # FLOP/s
HBM_RATE = 3.35e12    # bytes/s
L, F = 256, 129       # samples per ring, their rfft bins


def search_bound(n: int, nx: int, r: int, s: int, k: int, n_mirr: int):
    """(bound_ms, bound_by) of one search of ``n`` particles of ``nx`` px
    on ``r`` rings at ``s`` shifts against ``k`` references with
    ``n_mirr`` mirror channels: the larger of its float32 operations over
    the peak and its bytes (each input read once, each output written
    once) over the memory rate.  Per particle and shift it needs r x 256
    bilinear samples (8 operations each), r forward and n_mirr x k
    inverse real FFTs of 256 points (2.5 L log2 L each) and the k x r x
    129 complex products (8 operations each, both mirror channels from
    the same four real products)."""
    per_shift = (r * L * 8 + (r + n_mirr * k) * 2.5 * L * 8
                 + 8 * k * r * F)
    flops = float(n * s * per_shift)
    nbytes = (4 * n * nx * nx + 8 * n + 8 * r * L + 8 * s + 8 * k * r * F
              + 8 * L + n * 4 * (1 + L + 4))
    t_op, t_mem = flops / F32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_op, t_mem),
            "operations" if t_op >= t_mem else "bytes")
