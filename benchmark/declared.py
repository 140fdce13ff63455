"""The spans a program declares (``utils/profiling.py``'s ``SPANS``),
for the readers of spans that came after the first ones: such a reader
reads nothing from a checkout that predates its span, and fails where
the checkout declares the span and the profiled job has none."""

from __future__ import annotations


def declared(name: str) -> bool:
    """Whether the program in this checkout declares the span ``name``
    (False where it declares none: a checkout from before ``SPANS``)."""
    from cryo_ralib_tpu_torch.utils import profiling

    return name in getattr(profiling, "SPANS", ())
