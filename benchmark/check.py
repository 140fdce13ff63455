"""The comparison that decides ``correct``.

It follows the job the program ran, stage by stage, from the program's
own state where a stage needs it, and holds each stage's output to the
plain reference (``reference.py``):

* ``search_gap`` (exhaustive search) or ``shc_gap`` (SHC): for the
  sampled particles at every iteration, how far the program's winner
  falls short of the search's rule under the reference's scores,
  relative to the particle's best score: the reference's best minus its
  score of the program's pick; for SHC how far the pick lies below the
  particle's ``previousmax`` or an earlier candidate above it, or the
  pick's angle below its row's peak;
* ``row_err``: the program's ccf row of its winner against the
  reference's row of that candidate, relative to the row's peak;
* ``param_err``: the program's decoded params against the reference's
  decoding of the program's winner and row (degrees and pixels; a
  mirror or class that differs counts 1000);
* ``sums_err`` and ``counts_err``: the class sums and counts of every
  iteration against the reference's transform and sums of the whole
  stack by the program's params (relative to the largest sum; counts
  exact);
* ``refs_err``: the references each iteration searched against (and
  the last ones returned) against the reference's own update from the
  previous iteration's sums (relative to the largest value).

A sampled particle with no search record in an iteration makes the
three search numbers NaN, which fails, and is named on standard error.
The references of the first iteration are built from the inputs alone,
so the start is held on its own.  ``rounding`` (``reference.tf32``)
computes each stage in the control's precision in place of the
program's, from the same inputs (the search's products, the decode's
fit, the summed images, the update's sums), and reads the same
numbers.
"""

from __future__ import annotations

import random
import sys

import numpy as np
import torch

import reference as R

BLOCK = 256
MISMATCH = 1000.0


def prepared(stack, driver: str, mask, device):
    """The stack as ``mref_ali2d`` and ``ali2d_base`` search it: masked
    (mref: mean and sigma; reffree: mean), float32 on ``device``."""
    m = torch.as_tensor(mask, device=device)
    out = torch.empty(tuple(stack.shape), dtype=torch.float32, device=device)
    for s in range(0, stack.shape[0], 4096):
        x = torch.as_tensor(np.asarray(stack[s:s + 4096]), device=device)
        out[s:s + x.shape[0]] = R.normalize(x, m, driver == "mref_ali2d")
    return out


def _t(a, device, dtype=None):
    return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)


def search_numbers(records, images, geo: R.Geometry, shc: bool, device,
                   rounding=None) -> dict:
    """``search_gap``/``shc_gap``, ``row_err`` and ``param_err`` over the
    sampled particles of every iteration.  With ``rounding`` the control
    picks and rows stand in for the program's."""
    gap = row = par = 0.0
    unseen = False
    for t, it in enumerate(records):
        s, new = it["search"], it["new"]
        missing = np.setdiff1d(new["gidx"], s.get("gidx", []))
        if len(missing):
            print(f"check: iteration {t + 1}: {len(missing)} of "
                  f"{len(new['gidx'])} sampled particles have no search "
                  f"record (the capture saw no search that ran them)",
                  file=sys.stderr)
            unseen = True
            continue
        refs = _t(it["refs"], device)
        order = {g: i for i, g in enumerate(new["gidx"])}
        for b in range(0, len(s["gidx"]), BLOCK):
            sl = slice(b, b + BLOCK)
            g = s["gidx"][sl]
            x = images[_t(g, device)]
            prev = {f: _t(s["prev_" + f][sl], device)
                    for f in ("angle", "shift_x", "shift_y", "mirror",
                              "ref_id")}
            rows = R.all_rows(x, refs, prev["shift_x"], prev["shift_y"], geo)
            pm = _t(s["previousmax"][sl], device) if shc else None
            if rounding is None:
                pick = [_t(s[f][sl], device).long() for f in
                        ("best_mirror", "best_sidx", "best_ref", "best_aidx")]
                prow = _t(s["best_row"][sl], device)
                found = (_t(s["found"][sl], device) if shc
                         else torch.ones(len(g), dtype=torch.bool,
                                         device=device))
            else:
                crow = R.all_rows(x, refs, prev["shift_x"], prev["shift_y"],
                                  geo, rounding)
                if shc:
                    found, *pick = R.shc_pick(crow, pm)
                else:
                    pick = list(R.argmax_pick(crow))
                    found = torch.ones(len(g), dtype=torch.bool,
                                       device=device)
                prow = crow[(torch.arange(len(g), device=device),) + tuple(
                    pick[:3])]
            gap = max(gap, _gap(rows, pick, found, pm))
            rrow = rows[(torch.arange(len(g), device=device),)
                        + tuple(pick[:3])]
            err = ((prow - rrow).abs().amax(1)
                   / rrow.abs().amax(1).clamp(min=1e-30))
            row = max(row, float(torch.where(found, err, 0.0).amax()))
            want = _decoded(prow, pick, found, prev, geo, len(refs))
            if rounding is None:
                idx = [order[int(i)] for i in g]
                got = {f: _t(new[f][idx], device) for f in want}
            else:
                got = _decoded(rounding(prow), pick, found, prev, geo,
                               len(refs))
            par = max(par, _param_err(got, want))
    if unseen:
        gap = row = par = float("nan")
    return {"shc_gap" if shc else "search_gap": gap, "row_err": row,
            "param_err": par}


def _decoded(row, pick, found, prev, geo, n_refs: int) -> dict:
    """The params a winner decodes to (the previous ones where SHC found
    nothing)."""
    ang, sx, sy = R.decode(row, pick[3], pick[1], pick[0], prev["shift_x"],
                           prev["shift_y"], geo)
    want = {"angle": ang, "shift_x": sx, "shift_y": sy, "mirror": pick[0],
            "ref_id": prev["ref_id"] if n_refs == 1 else pick[2]}
    return {f: torch.where(found, v.to(prev[f].dtype), prev[f])
            for f, v in want.items()}


def _gap(rows, pick, found, pm) -> float:
    n, m, s, k, L = rows.shape
    ar = torch.arange(n, device=rows.device)
    if pm is None:
        best = rows.reshape(n, -1).amax(1)
        val = rows[ar, pick[0], pick[1], pick[2], pick[3]]
        return float(((best - val) / best.abs().clamp(min=1e-30)).amax())
    peaks = rows.amax(-1).reshape(n, -1)
    scale = peaks.abs().amax(1).clamp(min=1e-30)
    prio = (pick[0] * s + pick[1]) * k + pick[2]
    prio = torch.where(found, prio, m * s * k)
    early = torch.arange(m * s * k, device=rows.device)[None] < prio[:, None]
    above = torch.where(early, peaks - pm[:, None], 0.0).clamp(min=0).amax(1)
    at = peaks[ar, prio.clamp(max=m * s * k - 1)]
    below = torch.where(found, (pm - at).clamp(min=0), 0.0)
    row = rows[ar, pick[0], pick[1], pick[2]]
    angle = torch.where(found, row.amax(1) - row[ar, pick[3]], 0.0)
    worst = torch.stack([above, below, angle]).amax(0) / scale
    return float(worst.amax())


def _param_err(got: dict, want: dict) -> float:
    d = (got["angle"] - want["angle"]).abs() % 360.0
    d = torch.minimum(d, 360.0 - d)
    err = torch.stack([d, (got["shift_x"] - want["shift_x"]).abs(),
                       (got["shift_y"] - want["shift_y"]).abs()]).amax(0)
    bad = ((got["mirror"] != want["mirror"])
           | (got["ref_id"] != want["ref_id"]))
    return float(torch.where(bad, MISMATCH, err.double()).amax())


def sums_numbers(records, images, device, rounding=None) -> dict:
    """``sums_err`` and ``counts_err`` of every iteration."""
    se = ce = 0.0
    rnd = R.identity if rounding is None else rounding
    for it in records:
        p = {f: _t(v, device) for f, v in it["params"].items()}
        k = it["sums"].shape[0]
        ref, counts = R.class_sums(images, p["angle"], p["shift_x"],
                                   p["shift_y"], p["mirror"], p["ref_id"], k,
                                   rounding=rnd)
        got = _t(it["sums"], device, torch.float64)
        se = max(se, float((got - ref).abs().amax()
                           / ref.abs().amax().clamp(min=1e-300)))
        ce = max(ce, float(np.abs(np.asarray(it["counts"])
                                  - counts.cpu().numpy()).max()))
    return {"sums_err": se, "counts_err": ce}


def refs_numbers(records, final_refs, images, driver: str, init_refs,
                 mask, n: int, device, seed: int = 1000,
                 rounding=None) -> dict:
    """``refs_err``: each iteration's references against the reference's
    update (mref: of the previous sums and counts; reffree: of the
    previous sums and the mean header shift), the first ones against
    the inputs' own.  With ``rounding`` the control's update (its inputs
    rounded) stands in for the program's references."""
    if rounding is not None:
        def rnd(a):
            return rounding(torch.as_tensor(np.asarray(a, np.float32))
                            ).numpy()
        ctrl = [dict(it, sums=rnd(it["sums"])) for it in records]
        got = _updates(ctrl, images, driver, init_refs, mask, n, device,
                       seed, rnd)
    else:
        got = [it["refs"] for it in records]
        if driver == "mref_ali2d":
            got.append(np.asarray(final_refs))
    want = _updates(records, images, driver, init_refs, mask, n, device,
                    seed)
    err = 0.0
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        err = max(err, float(np.abs(np.asarray(g, np.float64) - w).max()
                             / max(np.abs(w).max(), 1e-300)))
    return {"refs_err": err}


def _updates(records, images, driver, init_refs, mask, n, device, seed,
             rnd=None) -> list:
    """The references of every iteration, and for mref the last ones,
    as the reference rebuilds them from the records' sums."""
    want = []
    if driver == "mref_ali2d":
        m = torch.as_tensor(mask)
        want.append(R.normalize(torch.as_tensor(init_refs), m,
                                sigma=False).numpy())
        rng = random.Random(seed)

        def particle(i):
            return images[i].cpu().numpy()

        for it in records:
            want.append(R.mref_update(np.asarray(it["sums"]), it["counts"],
                                      mask, n, rng, particle))
    else:
        raw = _raw_sums(images, device)
        if rnd is not None:
            raw = rnd(raw)
        want.append(R.reffree_average(raw, n, 0.0, 0.0, mask)[None])
        for it in records[:-1]:
            p = {f: _t(v, device) for f, v in it["params"].items()}
            sx, sy = R.header_shift_sums(p["angle"], p["shift_x"],
                                         p["shift_y"], p["mirror"])
            want.append(R.reffree_average(np.asarray(it["sums"]), n, sx, sy,
                                          mask)[None])
    return want


def _raw_sums(images, device):
    """(1, 2, H, W) float64 even/odd sums of the untransformed stack."""
    n = images.shape[0]
    out = torch.zeros((2,) + tuple(images.shape[1:]), dtype=torch.float64,
                      device=device)
    for s in range(0, n, 4096):
        x = images[s:s + 4096].double()
        par = torch.arange(s, s + x.shape[0], device=device) % 2
        out.index_add_(0, par, x)
    return out[None].cpu().numpy()


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the cell's limits; a
    number that is missing or not finite fails."""
    table = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok = ok and good
        table[name] = {"value": v, "limit": limit}
    return ok, table
