"""How far apart two bf16 computations of esrgan_gan's generator step
lie, on one GPU: the spread that decides which parts of chip_smoke.py's
phase-39 step check (check_gan_step) can be judged.

Runs phase 39 (chip_smoke.gan_train_path: esrgan_gan at full width and
depth, its Trainer's fit) --fits times. After each fit it takes the
fit's first batch in 8 orientations (4 rotations, each also mirrored).
For each, it computes the generator step's gradients of the whole GAN
loss (chip_smoke.gan_g_loss: l1 + perceptual + gan against the current
D) on four paths at the same f32 masters:
  kernel         the trainer's fused apply (B1 and kernel 13) in bf16
  plain          the plain model in bf16 (cuDNN)
  plain_nocudnn  the plain model in bf16 with cuDNN off (im2col + GEMM:
                 a second plain path with its own rounding)
  f32            the plain model in f32
It prints, for each path, the distances from the f32 path
(chip_smoke.rel_err, of max |f32|): of the pred, of the grad norm, and
of the loss's cotangent at that path's pred. It also counts the leaves
that break chip_smoke's f32_margin rule, |x - f32| > |y - f32| + 0.03,
for each ordered pair (x, y) of bf16 paths, and the norm's breaks. It
then runs check_gan_step's judged parts as phase 39 does: (1) the l1
step and (3) the shared-cotangent backward.

    python3 scripts/gan_step_spread.py [--fits N]

Needs a CUDA device. Lines are JSON; the last one sums the breaks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

PATHS = ("kernel", "plain", "plain_nocudnn")


def breaks(g: dict, ref: dict, g32: dict) -> int:
    """Leaves of g farther from f32 than ref's, plus TOL_LEAF."""
    return sum(cs.rel_err(g[k], g32[k])
               > cs.rel_err(ref[k], g32[k]) + cs.TOL_LEAF for k in g)


def spread(tr, lr, hr, prefixes, fit: int, totals: dict) -> None:
    from torch.func import functional_call

    from superresolution_tpu_torch.losses.basic import l1_loss
    from superresolution_tpu_torch.train.state import global_norm
    from superresolution_tpu_torch.utils.precision import get_policy

    bf16, f32 = get_policy("bf16"), get_policy("fp32")
    loss = cs.gan_g_loss(tr)

    def plain(p, x):
        return functional_call(tr.model, p, (x,))

    # name: (apply, policy, cuDNN on); plain_nocudnn's backward too
    paths = {"kernel": (tr.fused_apply, bf16, True),
             "plain": (plain, bf16, True),
             "plain_nocudnn": (plain, bf16, False),
             "f32": (plain, f32, True)}
    for turn in range(4):
        for mirror in (False, True):
            a, b = lr.rot90(turn, (1, 2)), hr.rot90(turn, (1, 2))
            if mirror:
                a, b = a.flip(2), b.flip(2)
            a, b = a.contiguous(), b.contiguous()
            grads, norms, preds, cots = {}, {}, {}, {}
            for name, (apply, pol, cudnn) in paths.items():
                with torch.backends.cudnn.flags(enabled=cudnn):
                    _, grads[name] = cs.step_grads(tr, apply, pol, a, b,
                                                   name == "kernel", loss)
                    with torch.no_grad():
                        preds[name] = apply(
                            pol.cast_to_compute(tr.state.params),
                            a.to(pol.compute_dtype)).float()
                norms[name] = global_norm(grads[name])
                p_ = preds[name].clone().requires_grad_()
                cots[name] = torch.autograd.grad(loss(p_, b.float(), bf16),
                                                 [p_])[0]
            line = {"fit": fit, "input": f"rot{turn}" + ("_mirror" * mirror),
                    "max_abs_pred_f32": float(preds["f32"].abs().max())}
            for name in PATHS:
                line[name] = {
                    "pred_vs_f32": cs.rel_err(preds[name], preds["f32"]),
                    "grad_norm_vs_f32": cs.rel_err(norms[name],
                                                   norms["f32"]),
                    "cotangent_vs_f32": cs.rel_err(cots[name],
                                                   cots["f32"])}
            for x in PATHS:
                for y in PATHS:
                    if x == y:
                        continue
                    n = breaks(grads[x], grads[y], grads["f32"])
                    norm_break = (line[x]["grad_norm_vs_f32"]
                                  > line[y]["grad_norm_vs_f32"]
                                  + cs.TOL_STEP_GNORM)
                    line[f"{x}_vs_{y}"] = {"leaves_broken": n,
                                           "norm_broken": norm_break}
                    t = totals.setdefault(f"{x}_vs_{y}", {
                        "inputs": 0, "inputs_with_leaves_broken": 0,
                        "norm_broken": 0})
                    t["inputs"] += 1
                    t["inputs_with_leaves_broken"] += n > 0
                    t["norm_broken"] += norm_break
            line["leaves"] = len(grads["f32"])
            for name, check in (
                    ("l1_step", lambda: cs.check_train_step(
                        tr, a, b, "spread/l1", prefixes=prefixes,
                        loss_fn=lambda pr, h, pol: l1_loss(pr, h),
                        against="f32_margin")),
                    ("cotangent", lambda: cs.check_gan_cotangent(
                        tr, a, b, prefixes, loss))):
                try:
                    check()
                    line[name] = "pass"
                except AssertionError as e:
                    line[name] = str(e)
                t = totals.setdefault(name, {"inputs": 0, "failed": 0})
                t["inputs"] += 1
                t["failed"] += line[name] != "pass"
            print(json.dumps({"spread": line}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fits", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gan_step_spread: no CUDA device", file=sys.stderr)
        return 1
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.runtime import exact_fp32_reference

    exact_fp32_reference()
    card = cs.nvidia_smi()
    print(card, flush=True)
    _build.build()
    _build.library()
    totals: dict = {}
    for fit in range(args.fits):
        cs.check_gan_step = (lambda tr, lr, hr, prefixes, fit=fit:
                             spread(tr, lr, hr, prefixes, fit, totals))
        cs.gan_train_path(card)
    print(json.dumps({"card": card, "fits": args.fits, "totals": totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
