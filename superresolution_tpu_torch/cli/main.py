"""The port's command line: `python -m superresolution_tpu_torch ...`.

Counterpart of superresolution_tpu/cli/main.py:21-400, 400-530, with the
same subcommands and flags:

  prepare-data      scan pair dirs -> train/val/test manifests
  train             run a preset's training, print the result as JSON
  finalize          promote the best checkpoint to final_weights
  test              evaluate the test split: PSNR/SSIM, TIFF16, strips
  upscale           tiled SR of an arbitrary image
  eval-folder       PSNR/SSIM over an HR folder (Set5/Set14 convention)
  benchmark         run chip_smoke.py (the repository root's)
  show-result       labelled comparison collage
  import-reference  a reference .pth -> the port's checkpoint directory
  astro-register    ETL step 1: plate-solve + register onto a common TAN
  astro-qc          ETL step 2: green/magenta alignment overlay PNG
  astro-extract     ETL step 3: WCS-aligned LR/HR patch pairs (FITS)
  astro-normalize   ETL step 4: global log-stretch -> 16-bit TIFF pairs
  presets           list the named configs

and one flag the port's device rule needs: --device (default cuda; the
CPU only when asked for). `upscale --fast-attn` runs a trained RRDBNet's
trunk through B1 and its x4 tail through B2/B3 (fused_rrdb_model), a
hybrid through kernels 7-10 (fused_hybrid_model); EDSR and ESPCN heads
are kernel 15 on the card. The astro-* steps run on the host.

Multi-process runs: under torchrun (RANK, WORLD_SIZE and LOCAL_RANK in
the environment, WORLD_SIZE > 1) a command that takes --device joins a
process group first, NCCL for --device cuda (rank r on cuda:LOCAL_RANK)
and gloo for --device cpu; then
`train --mesh-data N / --mesh-pipe N` trains on that mesh and `upscale
--mesh-data N` spreads the tiles over N ranks (parallel/). A mesh larger
than the world raises, with the reference's message. Rank 0 alone writes
files and prints results.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch "
                        "versions of the kernels)")


def _add_common(p):
    p.add_argument("--preset", default="edsr_baseline_x4")
    p.add_argument("--workdir", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--data-root", default=None,
                   help="directory of pair_* dirs (else synthetic data)")
    p.add_argument("--manifest-dir", default=None)
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-pipe", type=int, default=None,
                   help="pipeline stages for the RRDB trunk body"
                        " (requires an RRDBNet arch; see MeshConfig)")
    _add_device(p)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _init_distributed(args) -> bool:
    """Join the process group torchrun describes in the environment
    (WORLD_SIZE > 1); -> whether this call initialized one. --device cuda
    becomes this rank's card, cuda:LOCAL_RANK."""
    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world < 2 or dist.is_initialized():
        return False
    device = torch.device(args.device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
    dist.init_process_group(backend, init_method="env://")
    return True


def _config_from_args(args):
    from superresolution_tpu_torch.utils.config import get_preset

    cfg = get_preset(args.preset)
    data, train, mesh = cfg.data, cfg.train, cfg.mesh
    if args.manifest_dir:
        data = dataclasses.replace(
            data,
            train_manifest=os.path.join(args.manifest_dir, "train.json"),
            val_manifest=os.path.join(args.manifest_dir, "val.json"),
            test_manifest=os.path.join(args.manifest_dir, "test.json"))
    elif args.data_root:
        # scan pair_* dirs -> split manifests under the workdir -> train
        # on the real pairs
        from superresolution_tpu_torch.data.manifest import prepare_splits

        split_dir = os.path.join(
            args.workdir or os.path.join("outputs", cfg.name), "splits")
        paths = prepare_splits(args.data_root, split_dir, mode="split")
        data = dataclasses.replace(
            data, train_manifest=paths["train"], val_manifest=paths["val"],
            test_manifest=paths["test"])
    if args.batch_size:
        data = dataclasses.replace(data, batch_size=args.batch_size)
    if args.epochs:
        train = dataclasses.replace(train, epochs=args.epochs)
    if args.mesh_data:
        mesh = dataclasses.replace(mesh, data=args.mesh_data)
    if args.mesh_pipe:
        mesh = dataclasses.replace(mesh, pipe=args.mesh_pipe)
    return dataclasses.replace(cfg, data=data, train=train, mesh=mesh)


def cmd_prepare_data(args):
    from superresolution_tpu_torch.data.manifest import prepare_splits

    paths = prepare_splits(args.root, args.out, mode=args.mode,
                           val_frac=args.val_frac, seed=args.seed)
    print(json.dumps(paths, indent=2))


def cmd_train(args):
    from superresolution_tpu_torch.train.trainer import Trainer

    cfg = _config_from_args(args)
    with Trainer(cfg, workdir=args.workdir, device=args.device) as trainer:
        result = trainer.fit()
    if _rank() == 0:
        print(json.dumps(result))


def cmd_finalize(args):
    from superresolution_tpu_torch.train.checkpoint import CheckpointManager

    out = CheckpointManager(args.checkpoints).finalize(args.out)
    print(f"finalized -> {out}")


def cmd_test(args):
    from superresolution_tpu_torch.infer.evaluate import run_test
    from superresolution_tpu_torch.train.trainer import Trainer

    cfg = _config_from_args(args)
    with Trainer(cfg, workdir=args.workdir, device=args.device) as trainer:
        result = run_test(trainer, labeled=args.labeled)
    if _rank() == 0:
        print(json.dumps(result))


def _load_checkpoint(ckpt: str, device: str, fast_attn: bool = False):
    """(model, params, scale) rebuilt from a checkpoint directory's
    weights and model_config.json; with fast_attn the deploy forms:
    flash attention in a refiner, the fused hybrid (kernels 7-10) for a
    HATLite refiner, the fused RRDBNet (B1-B3) for a plain RRDBNet; a
    checkpoint they cannot bind raises. Without a model_config the model
    and scale are None (the caller's are kept)."""
    from superresolution_tpu_torch.models.factory import (
        build_from_config,
        total_scale,
    )
    from superresolution_tpu_torch.train.checkpoint import (
        load_params_for_inference,
    )
    from superresolution_tpu_torch.utils.config import ModelConfig

    params, mc = load_params_for_inference(ckpt, with_config=True,
                                           device=device)
    if not mc:
        return None, params, None
    mc.pop("output_size", None)
    if fast_attn and mc.get("refiner"):
        # kernel 10 for every window attention (f32 softmax in the kernel)
        mc["refiner_kwargs"] = dict(mc.get("refiner_kwargs") or {},
                                    attn_f32=False, flash_attn=True)
    mcfg = ModelConfig(**mc)
    # output_size None: tiles keep their natural x-scale size
    model = build_from_config(mcfg, output_size=None, device=device)
    scale = total_scale(mcfg)
    if fast_attn and mc.get("refiner") == "hat_lite":
        from superresolution_tpu_torch.infer.fused_hat import (
            fused_hybrid_model,
        )

        model = fused_hybrid_model(params, model, device=device)
    elif fast_attn and mc.get("name") == "rrdbnet" and not mc.get("refiner"):
        from superresolution_tpu_torch.infer.fused_trunk import (
            fused_rrdb_model,
        )

        model = fused_rrdb_model(params, model, device=device)
    return model, params, scale


def cmd_eval_folder(args):
    """PSNR/SSIM over an HR image folder (Set5/Set14 convention:
    Y channel, shave = scale, MATLAB-bicubic LR)."""
    import numpy as np

    from superresolution_tpu_torch.api import upscale
    from superresolution_tpu_torch.metrics.benchmark_eval import (
        evaluate_folder,
    )

    if not os.path.isdir(args.hr_dir):
        print(f"error: not a directory: {args.hr_dir}", file=sys.stderr)
        return 2
    params, model, scale = None, args.model, args.scale
    if args.ckpt:
        if not os.path.exists(args.ckpt):
            print(f"error: checkpoint not found: {args.ckpt}",
                  file=sys.stderr)
            return 2
        built, params, s = _load_checkpoint(args.ckpt, args.device)
        if built is not None:
            model, scale = built, s

    def up(lr):
        return np.asarray(upscale(lr, scale, model=model, params=params,
                                  tile=args.tile, halo=args.halo,
                                  device=args.device))

    result = evaluate_folder(up, args.hr_dir, scale, y_channel=not args.rgb)
    print(json.dumps(result))


def cmd_upscale(args):
    import numpy as np

    from superresolution_tpu_torch.api import upscale
    from superresolution_tpu_torch.data.io import (
        load_image,
        save_png,
        save_tiff16,
    )

    if not os.path.exists(args.input):
        print(f"error: input image not found: {args.input}", file=sys.stderr)
        return 2
    img = load_image(args.input)
    params, model, scale = None, args.model, args.scale
    if args.ckpt:
        if not os.path.exists(args.ckpt):
            print(f"error: checkpoint not found: {args.ckpt}",
                  file=sys.stderr)
            return 2
        built, params, s = _load_checkpoint(args.ckpt, args.device,
                                            fast_attn=args.fast_attn)
        if built is not None:
            model, scale = built, s
    if args.mesh_data and args.mesh_data > 1:
        if args.blend != "crop":
            # the staged tiler always crop-blends
            print(f"error: --blend {args.blend} is not supported with"
                  " --mesh-data > 1 (the staged tiler crop-blends);"
                  " use --blend crop", file=sys.stderr)
            return 2
        out = _upscale_mesh(args, img, scale, model, params)
        if out is None:
            return 2
    else:
        out = upscale(img, scale=scale, model=model, params=params,
                      tile=args.tile, halo=args.halo, blend=args.blend,
                      device=args.device)
    if _rank() != 0:
        return None
    if args.output.endswith((".tif", ".tiff")) and out.shape[-1] == 1:
        save_tiff16(out, args.output)
    else:
        save_png(np.asarray(out), args.output)
    print(f"{img.shape} -> {out.shape} saved to {args.output}")


def _upscale_mesh(args, img, scale, model, params):
    """Tile-parallel upscale over the --mesh-data ranks (the staged tiler
    with a mesh: infer/tiled_device.py), the reference's cli/main.py:
    218-254: a trunk/tail model (the rrdbnet family) only; None after
    printing the refusal."""
    import numpy as np
    import torch

    from superresolution_tpu_torch.infer.tiled import _default_model_params
    from superresolution_tpu_torch.infer.tiled_device import (
        make_tiled_infer_staged,
    )
    from superresolution_tpu_torch.models.rrdbnet import RRDBNet
    from superresolution_tpu_torch.parallel.mesh import create_mesh
    from superresolution_tpu_torch.utils.config import MeshConfig

    arr = img if img.ndim == 3 else img[..., None]
    model, params = _default_model_params(arr, scale, model, params,
                                          device=args.device)
    if not isinstance(model, RRDBNet):
        print("error: --mesh-data upscaling needs a trunk/tail"
              " model (the rrdbnet family) without --fast-attn",
              file=sys.stderr)
        return None
    mesh = create_mesh(MeshConfig(data=args.mesh_data, spatial=1))
    model.load_state_dict(params)
    dtype = next(model.parameters()).dtype
    h, w, c = arr.shape
    runner = make_tiled_infer_staged(
        lambda t: model.trunk(t.to(dtype)), model.tail, scale, args.tile,
        args.halo, tail_batch=4, h=h, w=w, channels=c, mesh=mesh,
        device=args.device)
    out = runner(torch.from_numpy(np.ascontiguousarray(arr)))
    out = out.float().cpu().numpy()
    return out[..., 0] if img.ndim == 2 else out


def cmd_benchmark(args):
    try:
        import chip_smoke  # the repository root's script, not installed
    except ModuleNotFoundError:
        print("benchmark requires a repo checkout: run from the"
              " repository root (chip_smoke.py is not installed)")
        raise SystemExit(2)
    return chip_smoke.main()


def cmd_show_result(args):
    import numpy as np

    from superresolution_tpu_torch.data.io import load_image
    from superresolution_tpu_torch.utils.collage import (
        frame_and_label_collage,
    )

    imgs = [load_image(p) for p in args.images]
    h = max(i.shape[0] for i in imgs)
    imgs = [np.pad(i, ((0, h - i.shape[0]), (0, 0), (0, 0))) for i in imgs]
    strip = np.concatenate(imgs, axis=1)
    labels = (args.labels.split(",") if args.labels
              else ["Input", "Result", "Target"][: len(imgs)])
    labels = (list(labels) + [""] * len(imgs))[: len(imgs)]
    out = frame_and_label_collage(
        strip, args.output, labels=tuple(labels),
        panel_widths=[i.shape[1] for i in imgs])
    print(f"collage -> {out}")


def cmd_import_reference(args):
    """A reference-ecosystem .pth (BasicSR ESRGAN RRDBNet, a bare HAT or
    the reference hybrid's stage1 / stage2 layout) -> OUT/best/state.pt
    and OUT/model_config.json, which `upscale --ckpt OUT/best` and
    load_params_for_inference read."""
    import shutil

    import torch

    from superresolution_tpu_torch.models.convert import (
        detect_reference_config,
    )
    from superresolution_tpu_torch.models.factory import build_from_config
    from superresolution_tpu_torch.utils.config import ModelConfig

    raw = torch.load(args.pth, map_location="cpu", weights_only=True)
    for wrap in ("params_ema", "params", "state_dict"):  # BasicSR wraps
        if wrap in raw and isinstance(raw[wrap], dict):
            raw = raw[wrap]
            break
    sd = {k: v.detach().float() for k, v in raw.items()
          if torch.is_tensor(v)}
    cfg = detect_reference_config({k: v.numpy() for k, v in sd.items()})
    model = build_from_config(ModelConfig(**cfg), output_size=None,
                              device="cpu")
    want = model.state_dict()
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"{args.pth} lacks {len(missing)} weights of the "
                       f"detected {cfg['name']} (first: {missing[:3]})")
    params = {k: sd[k].contiguous() for k in want}
    model.load_state_dict(params, strict=True)  # checks every shape
    out = os.path.abspath(args.out)
    best = os.path.join(out, "best")
    if os.path.exists(best):
        shutil.rmtree(best)
    os.makedirs(best)
    torch.save({"step": 0, "params": params, "opt_state": None,
                "ema_params": None}, os.path.join(best, "state.pt"))
    with open(os.path.join(out, "model_config.json"), "w") as f:
        json.dump(dict(cfg, output_size=None), f, indent=2)
    print(json.dumps({"checkpoint": best, "model": cfg["name"],
                      "refiner": cfg["refiner"]}))


def _glob_fits(d):
    import glob

    return sorted(
        f for pat in ("*.fits", "*.fit", "*.fts")
        for f in glob.glob(os.path.join(d, pat))
        if not os.path.basename(f).startswith("reg_"))


def cmd_astro_register(args):
    from superresolution_tpu_torch.astro.pipeline import register_images

    out = register_images(_glob_fits(args.hubble_dir),
                          _glob_fits(args.obs_dir), args.out,
                          workers=args.workers, fov_deg=args.fov)
    print(json.dumps({k: len(v) for k, v in out.items()} | {"dir": args.out}))


def cmd_astro_qc(args):
    import glob

    from superresolution_tpu_torch.astro.pipeline import qc_overlay

    reg = sorted(glob.glob(os.path.join(args.registered_dir, "reg_*.fits")))
    hub = [f for f in reg if args.hubble_tag in os.path.basename(f)]
    obs = [f for f in reg if args.hubble_tag not in os.path.basename(f)]
    out = qc_overlay(hub or reg, obs or reg, args.out, max_obs=args.max_obs)
    print(f"QC overlay -> {out}")


def cmd_astro_extract(args):
    import glob

    from superresolution_tpu_torch.astro.pipeline import extract_patches

    # registered (reg_*) frames are valid inputs here; exclude the master
    obs = sorted(
        f for pat in ("*.fits", "*.fit", "*.fts")
        for f in glob.glob(os.path.join(args.obs_dir, pat))
        if os.path.abspath(f) != os.path.abspath(args.hubble))
    n = extract_patches(args.hubble, obs, args.out,
                        hr_size=args.hr_size, stride=args.stride,
                        factor=args.factor, workers=args.workers)
    print(json.dumps({"pairs": n, "dir": args.out}))


def cmd_astro_normalize(args):
    from superresolution_tpu_torch.astro.pipeline import normalize_pairs

    n = normalize_pairs(args.pairs, args.out, black_p=args.black_p,
                        white_p=args.white_p)
    print(json.dumps({"pairs": n, "dir": args.out}))


def cmd_presets(args):
    from superresolution_tpu_torch.models.factory import total_scale
    from superresolution_tpu_torch.utils.config import presets

    for name, cfg in sorted(presets.items()):
        print(f"{name:22s} model={cfg.model.name:9s} "
              f"x{total_scale(cfg.model)} loss={sorted(cfg.loss.terms)}")


def build_parser():
    p = argparse.ArgumentParser("superresolution_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("prepare-data")
    s.add_argument("--root", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--mode", choices=["split", "overfit"], default="split")
    s.add_argument("--val-frac", type=float, default=0.1)
    s.add_argument("--seed", type=int, default=42)
    s.set_defaults(fn=cmd_prepare_data)

    s = sub.add_parser("train")
    _add_common(s)
    s.set_defaults(fn=cmd_train)

    s = sub.add_parser("finalize")
    s.add_argument("--checkpoints", required=True)
    s.add_argument("--out", required=True)
    s.set_defaults(fn=cmd_finalize)

    s = sub.add_parser("test")
    _add_common(s)
    s.add_argument("--labeled", action="store_true")
    s.set_defaults(fn=cmd_test)

    s = sub.add_parser("upscale")
    s.add_argument("--input", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--scale", type=int, default=4)
    s.add_argument("--model", default="rrdbnet")
    s.add_argument("--ckpt", default=None,
                   help="checkpoint dir (training checkpoints or "
                        "final_weights/best) to load params from")
    s.add_argument("--fast-attn", action="store_true",
                   help="the deploy kernels: an RRDBNet through B1-B3, a "
                        "hybrid through kernels 7-10, attention refiners "
                        "through kernel 10 (f32 softmax in the kernel)")
    s.add_argument("--tile", type=int, default=256)
    s.add_argument("--halo", type=int, default=16)
    s.add_argument("--blend", default="crop", choices=["crop", "hann"])
    s.add_argument("--mesh-data", type=int, default=None,
                   help="shard the tile batch over N ranks (under"
                        " torchrun; N > 1 needs an rrdbnet-family model)")
    _add_device(s)
    s.set_defaults(fn=cmd_upscale)

    s = sub.add_parser("eval-folder",
                       help="PSNR/SSIM over an HR folder (Set5/Set14"
                            " Y-channel convention)")
    s.add_argument("hr_dir")
    s.add_argument("--ckpt", default="")
    s.add_argument("--model", default="rrdbnet")
    s.add_argument("--scale", type=int, default=4)
    s.add_argument("--tile", type=int, default=256)
    s.add_argument("--halo", type=int, default=16)
    s.add_argument("--rgb", action="store_true",
                   help="metrics on RGB instead of the Y channel")
    _add_device(s)
    s.set_defaults(fn=cmd_eval_folder)

    s = sub.add_parser("benchmark")
    s.set_defaults(fn=cmd_benchmark)

    s = sub.add_parser("show-result")
    s.add_argument("--images", nargs="+", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--labels", default=None,
                   help="comma-separated panel labels")
    s.set_defaults(fn=cmd_show_result)

    s = sub.add_parser("import-reference",
                       help="convert a reference-ecosystem .pth into a "
                            "checkpoint dir for `upscale --ckpt`")
    s.add_argument("--pth", required=True)
    s.add_argument("--out", required=True)
    s.set_defaults(fn=cmd_import_reference)

    # the reference's 4 numbered ETL stages (Dataset_step1..4) as
    # non-interactive subcommands, on the host
    s = sub.add_parser("astro-register",
                       help="step 1: plate-solve + register onto common TAN")
    s.add_argument("--hubble-dir", required=True)
    s.add_argument("--obs-dir", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--workers", type=int, default=2)
    s.add_argument("--fov", type=float, default=None,
                   help="blind-solve FOV override in degrees")
    s.set_defaults(fn=cmd_astro_register)

    s = sub.add_parser("astro-qc",
                       help="step 2: green/magenta alignment overlay PNG")
    s.add_argument("--registered-dir", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--hubble-tag", default="hst",
                   help="substring marking Hubble frames among reg_*.fits")
    s.add_argument("--max-obs", type=int, default=10)
    s.set_defaults(fn=cmd_astro_qc)

    s = sub.add_parser("astro-extract",
                       help="step 3: WCS-aligned LR/HR patch pair extraction")
    s.add_argument("--hubble", required=True, help="master Hubble FITS")
    s.add_argument("--obs-dir", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--hr-size", type=int, default=512)
    s.add_argument("--stride", type=int, default=75)
    s.add_argument("--factor", type=int, default=4)
    s.add_argument("--workers", type=int, default=4)
    s.set_defaults(fn=cmd_astro_extract)

    s = sub.add_parser("astro-normalize",
                       help="step 4: global log-stretch -> 16-bit TIFF pairs")
    s.add_argument("--pairs", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--black-p", type=float, default=3.0)
    s.add_argument("--white-p", type=float, default=99.99)
    s.set_defaults(fn=cmd_astro_normalize)

    s = sub.add_parser("presets")
    s.set_defaults(fn=cmd_presets)
    return p


def main(argv=None):
    from superresolution_tpu_torch.runtime import setup_kernel_cache

    args = build_parser().parse_args(argv)
    if getattr(args, "device", None) is None:
        return args.fn(args)
    joined = _init_distributed(args)
    try:
        setup_kernel_cache(args.device)
        return args.fn(args)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
