"""The training cells' numbers against the reference.

Every gap is a share. The cell's limits file names the numbers compared;
the readings (`READINGS`) are computed with `--control` only.
  * `loss_gap` (`loss1_gap`: the first step alone): the first three steps'
    G and D losses, |program − reference| over the sum of the magnitudes of
    the loss's terms in the reference;
  * `grad_gap`, `grad_median_gap`: the first step's gradient (the momentum
    buffer after it, less the weight decay), gap of norms of the worst and
    of the median leaf (`harness.leaf_gap`), over student and D;
  * `update_gap`, `update_median_gap`: the change of the parameters over the
    first three steps, worst and median leaf;
  * `replay_loss_gap`, `replay_update_gap`: the four losses of the replayed
    chunk after the window, followed from the program's state before it,
    and its change of the worst leaf;
  * `var1_median_gap`: the first step's batch variance at each of the
    student's batch norms (from its running variance after the step), gap
    of norms of the median norm. Rounding adds its own variance to every
    activation, so this gap grows with the square of the rounding error in
    the activations, where the others, sums in which unbiased rounding
    cancels, grow no faster than the error.
Leaves whose first-step reference gradient is under a thousandth of the
median leaf's (a key bias under the attention's softmax, a bias before a
batch norm) move by round-off alone and are left out, by that rule.

With `--control` three stand-ins take the program's place, each the
reference with one change: `control`, rounded to the type below the
configuration's (`precision.Rounded`: fp8, e4m3 forward and e5m2 gradients,
for the bf16 step); `half_batch`, a fault, on half of each batch; `bf16`, a
witness, rounded to the program's own type, whose gaps show what rounding
alone does to each number.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

from benchmark.harness import leaf_gap, worst_leaf
from benchmark.reference import kd_step, nets, precision

__all__ = ["train_numbers", "norms", "kept_leaves"]

READINGS = ("loss_gap", "grad_gap", "update_gap", "leaf.grad_gap", "leaf.update_gap")

FP8 = getattr(torch, "float8_e4m3fn", None)
FP8_GRAD = getattr(torch, "float8_e5m2", None)


def norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def kept_leaves(grad_norms: Dict[str, float]) -> set:
    med = statistics.median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v >= 1e-3 * med}


def _dev(d, dev):
    return {k: v.to(dev) for k, v in d.items()}


def _delta(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor], names) -> Dict[str, float]:
    return {k: float((a[k].double().cpu() - b[k].double().cpu()).norm()) for k in names}


def batch_vars(stats: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor],
               m: float = nets.BN_MOMENTUM) -> Dict[str, float]:
    """Each batch norm's first batch variance (Bessel-corrected), as a norm,
    from its running variance after the step and before it."""
    return {k: float(((v.double().cpu() - (1 - m) * start[k].double().cpu()) / m).norm())
            for k, v in stats.items()}


def _loss_gap(prog, ref, recipe) -> float:
    """The worst step's |program − reference| over the reference's scale;
    a loss that is not finite on either side is an infinite gap."""
    gaps = []
    for p, r in zip(prog, ref):
        gaps.append(abs(p["g_loss"] - r["g_loss"]) / r["g_scale"])
        if recipe.ho:
            gaps.append(abs(p["d_loss"] - r["d_loss"]) / r["d_scale"])
    if len(prog) != len(ref) or not gaps or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def _draws(state=None, seed=None):
    g = torch.Generator()
    if state is not None:
        g.set_state(state)
    else:
        g.manual_seed(seed)
    return lambda shape: torch.rand(shape, generator=g)


def _half(batches):
    return [(x[: x.shape[0] // 2], y[: y.shape[0] // 2]) for x, y in batches]


def _follow(specs, recipe, teacher, start, batches, prec, draws, first_step):
    dev = next(iter(teacher.values())).device
    st = {"teacher": teacher, **{k: _dev(start.get(k, {}), dev)
                                 for k in ("student", "disc", "g_buf", "d_buf")}}
    return kd_step.ref_steps(specs, st, batches, recipe, prec, draws, first_step)


def _per_leaf(p: Dict[str, float], r: Dict[str, float], keep) -> Dict[str, float]:
    """Each kept leaf's gap, as `harness.leaf_gap` takes the worst of them."""
    names = [k for k in r if k in keep]
    med = statistics.median(r[k] for k in names)
    return {k: abs(p.get(k, math.nan) - r[k]) / max(r[k], med, 1e-30) for k in names}


def _gaps(prog: dict, ref: dict, ref_grads, base: dict, recipe) -> Dict[str, float]:
    """The six gaps of a program (or of a stand-in) against the reference,
    the readings, and under "per_leaf" each kept leaf's first-gradient and
    three-step-change gap. `prog`/`ref`: {"start_losses", "grads" (module →
    name → norm), "vars1" (name → norm), "after3" (module → state),
    "replay_losses", "replay_after"}."""
    out = {"loss_gap": _loss_gap(prog["start_losses"], ref["start_losses"], recipe),
           "loss1_gap": _loss_gap(prog["start_losses"][:1], ref["start_losses"][:1], recipe),
           "replay_loss_gap": _loss_gap(prog["replay_losses"], ref["replay_losses"], recipe),
           "var1_median_gap": leaf_gap(prog["vars1"], ref["vars1"], set(ref["vars1"]),
                                       statistics.median)}
    worst = {"grad_gap": 0.0, "update_gap": 0.0, "replay_update_gap": 0.0}
    median = {"grad_median_gap": 0.0, "update_median_gap": 0.0}
    per_leaf = {"grad": {}, "update": {}}
    for mod in ("student", "disc"):
        if not ref_grads[mod]:
            continue
        keep = kept_leaves(ref_grads[mod])
        names = list(ref_grads[mod])
        pairs = {
            "grad": (prog["grads"][mod], ref_grads[mod]),
            "update": (_delta(prog["after3"][mod], base["start"][mod], names),
                       _delta(ref["after3"][mod], base["start"][mod], names)),
            "replay_update": (_delta(prog["replay_after"][mod], base["replay"][mod], names),
                              _delta(ref["replay_after"][mod], base["replay"][mod], names)),
        }
        for key, (p, r) in pairs.items():
            gap = leaf_gap(p, r, keep)
            if gap >= worst[key + "_gap"]:
                out[f"leaf.{key}_gap"] = f"{mod}.{worst_leaf(p, r, keep)}"
            worst[key + "_gap"] = max(worst[key + "_gap"], gap)
            if key in per_leaf:
                per_leaf[key].update({f"{mod}.{k}": v
                                      for k, v in _per_leaf(p, r, keep).items()})
            if key + "_median_gap" in median:
                median[key + "_median_gap"] = max(median[key + "_median_gap"],
                                                  leaf_gap(p, r, keep, statistics.median))
    out.update(worst)
    out.update(median)
    out["per_leaf"] = per_leaf
    return out


def _reference_side(specs, recipe, teacher, state0, before, start_batches, replay_batches,
                    draw_seed, prec):
    ref = _follow(specs, recipe, teacher, state0, start_batches, prec,
                  _draws(seed=draw_seed), 0)
    rep = _follow(specs, recipe, teacher, before, replay_batches, prec,
                  _draws(state=before["generator"]), before["step"])
    return {"start_losses": ref["losses"],
            "grads": {m: norms(ref["first_grads"][m]) for m in ("student", "disc")},
            "vars1": batch_vars(ref["first_stats"], state0["student"]),
            "after3": {"student": ref["state"]["student"], "disc": ref["state"]["disc"]},
            "replay_losses": rep["losses"],
            "replay_after": {"student": rep["state"]["student"], "disc": rep["state"]["disc"]}}


def train_numbers(specs, recipe, state0, after1, after3, start_losses, before, after,
                  replay_losses, pool, k_check, unroll, draw_seed, dev,
                  control: bool = False) -> dict:
    """The gaps of the program; with `control`, also the readings and the
    gaps of the stand-ins (`control.*`, `half_batch.*`, `bf16.*`)."""
    teacher = _dev(state0["teacher"], dev)
    start_batches = [pool.f32(0, 0, dev), pool.f32(1, 0, dev), pool.f32(1, 1, dev)]
    replay_batches = [pool.f32(k_check, i, dev) for i in range(unroll)]
    ref = _reference_side(specs, recipe, teacher, state0, before, start_batches,
                          replay_batches, draw_seed, precision.Exact())
    wd = recipe.wd
    grads = {}
    for mod, buf in (("student", after1["g_buf"]), ("disc", after1["d_buf"])):
        grads[mod] = {k: float((v.double() - wd * state0[mod][k].double()).norm())
                      for k, v in buf.items()}
    prog = {"start_losses": start_losses, "grads": grads,
            "vars1": batch_vars(after1["stats"], state0["student"]),
            "after3": {"student": after3["student"], "disc": after3["disc"]},
            "replay_losses": replay_losses,
            "replay_after": {"student": after["student"], "disc": after["disc"]}}
    base = {"start": state0, "replay": before}
    numbers = _gaps(prog, ref, ref["grads"], base, recipe)
    program_leaves = numbers.pop("per_leaf")
    if not control:
        for k in READINGS:
            numbers.pop(k)
    numbers["terms.step1"] = {"program": start_losses[0], "reference": ref["start_losses"][0]}
    numbers["terms.replay"] = {"program": [m["g_loss"] for m in replay_losses],
                               "reference": [m["g_loss"] for m in ref["replay_losses"]]}
    if control:
        leaves = {}
        stand_ins = {"control": (precision.Rounded(FP8, FP8_GRAD), start_batches, replay_batches),
                     "half_batch": (precision.Exact(), _half(start_batches),
                                    _half(replay_batches)),
                     "bf16": (precision.Rounded(torch.bfloat16), start_batches,
                              replay_batches)}
        for label, (prec, sb, rb) in stand_ins.items():
            side = _reference_side(specs, recipe, teacher, state0, before, sb, rb, draw_seed,
                                   prec)
            gaps = _gaps(side, ref, ref["grads"], base, recipe)
            leaves[label] = gaps.pop("per_leaf")
            for k, v in gaps.items():
                numbers[f"{label}.{k}"] = v
            numbers[f"terms.step1.{label}"] = side["start_losses"][0]
        # the program's six worst leaves beside the stand-ins' gaps there
        for key, gaps in program_leaves.items():
            top = sorted(gaps, key=lambda k: -gaps[k])[:6]
            numbers[f"leaves.{key}"] = [[k, gaps[k]] + [leaves[s][key][k] for s in stand_ins]
                                        for k in top]
    return numbers
