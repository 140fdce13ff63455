"""The reader of ``step.search_interior_pct``: the share of the kernel's
unclamped ring samplings over the recorded job's ``step.search`` spans,
and nothing where no span carries the count."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import harness
from cryo_ralib_tpu_torch.utils import profiling

METRIC = "step.search_interior_pct"


def _span(name, **attrs):
    return SimpleNamespace(name=name, attrs=attrs)


def test_share_over_every_counted_search(monkeypatch):
    spans = [_span("job"), _span("engine.iterate"),
             _span("step.search", interior_rings=90, rings_full=100),
             _span("step.sums"),
             _span("step.search", interior_rings=60, rings_full=100)]
    monkeypatch.setattr(profiling, "last_job", lambda: spans)
    assert harness.reader(METRIC)({}) == pytest.approx(75.0)


@pytest.mark.parametrize("spans", [[], [_span("step.search", K=8)]],
                         ids=["no-job", "no-count"])
def test_nothing_without_the_count(monkeypatch, spans):
    monkeypatch.setattr(profiling, "last_job", lambda: spans)
    assert harness.reader(METRIC)({}) is None


def test_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "last_job")
    assert harness.reader(METRIC)({}) is None
