"""Alignment configuration and search-grid geometry.

TPU-native equivalent of the reference's ``AlignConfig`` struct and the
polar/shift grid generators (reference: ``cuda/gpu_aln_common.h:62-83``,
``cuda/gpu_aln_common.cu:39-84``).  Unlike the CUDA build, the config is a
frozen dataclass whose derived grids are plain numpy arrays baked into the
jitted alignment step as compile-time constants (static shapes are what XLA
wants; there is no runtime "reset_shifts" mutation — a new config simply
triggers a re-jit, which is cached per shape).
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import numpy as np

# Default polar-sampling parameters, mirroring the CUDA defaults
# (reference: cuda/gpu_aln_common.h:48-54).
DEFAULT_RING_LEN = 256


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Static parameters of a 2D rotational+translational alignment search.

    Mirrors the reference ``AlignConfig`` (cuda/gpu_aln_common.h:62-76):
      sbj_num/ref_num are runtime array dims here and therefore omitted —
      JAX shapes carry them.

    Attributes:
      img_dim:    square image side length in pixels (nx).
      ring_num:   number of polar rings; ring i sits at radius
                  ``first_ring + i * ring_step`` (defaults: radius i+1,
                  the CUDA scheme).
      ring_len:   number of samples per ring (uniform across rings, unlike
                  EMAN2's variable-length Numrinit rings; matches the CUDA
                  path which hardcodes 256).
      first_ring: radius of the innermost ring (the CLI ``--ir``; the
                  reference GPU config ignores it, but its CPU twin honors
                  ``Numrinit(first_ring, ...)``,
                  test_mref_gpu_align.py:338 — here it is real behavior).
      ring_step:  radius increment between rings (``--rs``,
                  ``Numrinit(..., rstep)``).
      shift_step: step of the x/y shift grid (``ts``).
      shift_rng_x / shift_rng_y: inclusive +/- shift search ranges.
      mode: "F" full rings (the only mode the reference GPU path supports)
            or "H" half rings — samples theta in [0, pi) so the rotation
            search covers [0, 180); the EMAN2 CPU twin uses this for SCF
            randomization (test_reffree_gpu_align.py:714, sp_alignment
            ``Numrinit(mode="H")`` convention).
      mirror: search the mirrored orientation channel (``--nomirror``
            disables it; the reference CPU twin's ``nomirror`` flag,
            test_reffree_gpu_align.py:921 — its GPU path always mirrors).
      ring_scheme: "cuda" (default) = uniform ``ring_len`` samples per
            ring with radius-linear weights — the reference GPU scheme;
            "eman2" = the CPU twin's variable-length ``Numrinit`` rings
            + ``ringwe`` weights (test_mref_gpu_align.py:741-750), for
            users who need EMAN2-CPU-exact numbers.  Under "eman2" the
            ``ring_len`` field is derived (maxrin, the longest ring) and
            the search runs ``ops.eman_search`` (fused/template gate
            themselves out).
    """

    img_dim: int
    ring_num: int = 32
    ring_len: int = DEFAULT_RING_LEN
    shift_step: float = 1.0
    shift_rng_x: float = 0.0
    shift_rng_y: float = 0.0
    mode: str = "F"
    mirror: bool = True
    first_ring: int = 1
    ring_step: int = 1
    ring_scheme: str = "cuda"

    def __post_init__(self):
        if self.img_dim <= 0:
            raise ValueError("img_dim must be positive")
        if self.ring_num <= 0:
            raise ValueError("ring_num must be positive")
        if self.first_ring < 1:
            raise ValueError("first_ring must be >= 1")
        if self.ring_step < 1:
            raise ValueError("ring_step must be >= 1")
        if self.ring_scheme not in ("cuda", "eman2"):
            raise ValueError("ring_scheme must be 'cuda' or 'eman2'")
        if self.ring_scheme == "eman2":
            if self.mode != "F":
                raise ValueError("ring_scheme='eman2' supports full rings "
                                 "only (mode='F')")
            # ring_len is derived: maxrin of the Numrinit plan
            object.__setattr__(self, "ring_len", self.eman_rings[-1][1])
        if self.ring_len % 2 != 0:
            raise ValueError("ring_len must be even (rfft over rings)")
        if self.shift_step <= 0:
            raise ValueError("shift_step must be positive")
        if self.mode not in ("F", "H"):
            raise ValueError("mode must be 'F' (full rings) or 'H' (half)")
        # Same sanity check as the reference drivers
        # (test_mref_gpu_align.py:314-316): particle must not cross the
        # image boundary under the largest shift.
        if self.max_radius + max(self.shift_rng_x, self.shift_rng_y) > (self.img_dim - 1) // 2:
            raise ValueError(
                "Shift or radius is too large - particle crosses image boundary"
            )

    @property
    def max_radius(self) -> int:
        """Radius of the outermost ring (== ring_num at the defaults)."""
        return self.first_ring + (self.ring_num - 1) * self.ring_step

    @cached_property
    def eman_rings(self) -> tuple:
        """Numrinit ring plan [(radius, ring_len), ...] — the
        ``ring_scheme="eman2"`` geometry (cryo_ralib_tpu/rings.py)."""
        from .rings import numrinit

        return tuple(numrinit(self.first_ring, self.max_radius,
                              self.ring_step, self.mode))

    @cached_property
    def eman_ring_weights(self) -> np.ndarray:
        """(ring_num,) ``ringwe`` weights of the eman2 scheme."""
        from .rings import ringwe

        return ringwe(list(self.eman_rings), self.mode).astype(np.float32)

    @cached_property
    def radii(self) -> np.ndarray:
        """(ring_num,) ring radii: ``first_ring + i * ring_step``."""
        return (self.first_ring
                + np.arange(self.ring_num, dtype=np.float64) * self.ring_step)

    @cached_property
    def polar_coords(self) -> np.ndarray:
        """(ring_num, ring_len, 2) array of (x, y) offsets from image center.

        Ring ``i`` lies at radius ``first_ring + i * ring_step`` (radius
        i+1 at the defaults); sample ``j`` at angle
        ``j / ring_len * 2*pi`` (mode "F") or ``j / ring_len * pi``
        (mode "H": the half-circle sampling of EMAN2's
        ``Polar2Dm(mode="H")``).  Equivalent of
        ``generate_polar_sampling_points`` (cuda/gpu_aln_common.cu:39-62).
        """
        r = self.radii[:, None]
        j = np.arange(self.ring_len, dtype=np.float64)[None, :]
        span = 2.0 * math.pi if self.mode == "F" else math.pi
        ang = j / float(self.ring_len) * span
        x = np.cos(ang) * r
        y = np.sin(ang) * r
        return np.stack([x, y], axis=-1).astype(np.float32)

    @cached_property
    def shift_x_vals(self) -> np.ndarray:
        """Distinct x shifts of the search grid, ascending."""
        return np.asarray(_inclusive_range(self.shift_rng_x, self.shift_step),
                          np.float32)

    @cached_property
    def shift_y_vals(self) -> np.ndarray:
        """Distinct y shifts of the search grid, ascending."""
        return np.asarray(_inclusive_range(self.shift_rng_y, self.shift_step),
                          np.float32)

    @cached_property
    def shifts(self) -> np.ndarray:
        """(S, 2) array of (sx, sy) global search shifts.

        Cartesian grid [-xr..xr] x [-yr..yr] in steps of ``shift_step``,
        x-major like ``generate_shift_array`` (cuda/gpu_aln_common.cu:64-84):
        global index = xi * len(shift_y_vals) + yi.
        """
        grid = [(x, y) for x in self.shift_x_vals for y in self.shift_y_vals]
        return np.asarray(grid, dtype=np.float32).reshape(-1, 2)

    @property
    def n_shifts(self) -> int:
        return int(self.shifts.shape[0])

    @property
    def n_freq(self) -> int:
        """Number of rfft frequency bins per ring."""
        return self.ring_len // 2 + 1

    @cached_property
    def ring_weights(self) -> np.ndarray:
        """(ring_num,) linear ring weights.

        The CUDA ccf kernels weight ring ``i`` by ``(i+1)``
        (cuda/gpu_aln_noref.cu:978-981) — radius-proportional weighting of
        the uniform-length rings, generalized here to the ring's actual
        radius for non-default first_ring/ring_step.  (EMAN2's CPU path
        uses ``ringwe`` weights over variable-length rings instead; we
        follow the reference GPU behavior, see SURVEY.md §3.3.)
        """
        return self.radii.astype(np.float32)

    @property
    def angle_step(self) -> float:
        """Degrees per angle bin of the rotational ccf: the ring span
        (360 for "F", 180 for "H" — EMAN2 ``ang_n`` convention) divided by
        ring_len."""
        return (360.0 if self.mode == "F" else 180.0) / self.ring_len

    @property
    def shift_limit(self) -> float:
        """Clamp bound for accumulated per-particle shifts.

        Matches ``CcfResultTable::compute_alignment_param``:
        ``img_dim - ring_num - 2`` (cuda/gpu_aln_noref.cu:2262), with
        ring_num generalized to the outermost ring radius (identical at
        the default first_ring/ring_step).
        """
        return float(self.img_dim - self.max_radius - 2)


def _inclusive_range(rng: float, step: float) -> list[float]:
    """[-rng, -rng+step, ..., rng] with float-safe inclusive upper bound."""
    vals = []
    s = -float(rng)
    # guard against float drift excluding the endpoint (matches the C loop
    # `for(s=-rng; s<=rng; s+=step)` closely enough for sane rng/step)
    eps = step * 1e-4
    while s <= rng + eps:
        vals.append(round(s / step) * step if step else s)
        s += step
    return [float(v) for v in vals]
