"""The port's command line (superresolution_tpu_torch/cli/main.py) and the
remaining utils (utils/profiling.py, runtime.setup_kernel_cache), in
process on the CPU (--device cpu), the way tests/test_cli.py drives the
JAX package's: presets, prepare-data, upscale (ESPCN, host tiler), a
tiny train, the friendly error on a missing input, eval-folder,
finalize, show-result, a --mesh-data / --mesh-pipe larger than the world
raising with the reference's message (the multi-process runs themselves:
tests/test_torch_parallel.py); import-reference of a synthetic BasicSR
RRDBNet .pth into `upscale --ckpt`; `upscale --ckpt assets/quality/port`
against api.upscale with the same weights (1e-3, the tilers' bar).
Against the JAX package: the presets listing, the subcommands and their
flags, finite_check's message, and the astro-* subcommands' JSON lines
and files on the same synthetic frames."""

import json
import os

import numpy as np
import pytest
import torch

from superresolution_tpu.cli.main import build_parser as jax_parser
from superresolution_tpu.cli.main import main as jax_main
from superresolution_tpu.utils.profiling import finite_check as jax_finite
from superresolution_tpu_torch import api
from superresolution_tpu_torch.cli.main import build_parser, main
from superresolution_tpu_torch.data import io as tio
from superresolution_tpu_torch.data.io import load_image, save_png
from superresolution_tpu_torch.models.convert import detect_reference_config
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.runtime import setup_kernel_cache
from superresolution_tpu_torch.train.checkpoint import (
    load_params_for_inference,
)
from superresolution_tpu_torch.utils.profiling import finite_check, trace

ANCHOR = os.path.join(os.path.dirname(__file__), "..", "assets", "quality",
                      "port")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These CPU tensors are small: intra-op threads gain nothing, and on
    a host loaded by parallel test workers their spin-waits cost several
    times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setenv("SRTPU_NO_TB", "1")


@pytest.fixture
def captured(monkeypatch):
    """The float array upscale hands to save_png (the PNG rounds it to
    8 bits), still written to disk."""
    got = {}

    def spy(arr, path):
        got["out"] = np.array(arr)
        save_png(arr, path)

    monkeypatch.setattr(tio, "save_png", spy)
    return got


def test_presets_listing_matches_jax(capsys):
    main(["presets"])
    out = capsys.readouterr().out
    jax_main(["presets"])
    assert out == capsys.readouterr().out
    assert len(out.strip().splitlines()) == 9
    assert "esrgan_gan" in out and "hybrid_astro_h200" in out


def _flags(parser) -> dict:
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {name: sorted(o for a in p._actions for o in a.option_strings
                         if o not in ("-h", "--help"))
            for name, p in sub.choices.items()}


def test_subcommands_and_flags_match_jax():
    """Every subcommand of the reference, the astro ETL's too, with its
    flags, plus --device where a command runs a model."""
    want = _flags(jax_parser())
    got = _flags(build_parser())
    assert sorted(got) == sorted(want)
    for name, flags in want.items():
        extra = ["--device"] if name in ("train", "test", "upscale",
                                         "eval-folder") else []
        assert got[name] == sorted(flags + extra), name
    args = build_parser().parse_args(["upscale", "--input", "a", "--output",
                                      "b"])
    assert args.device == "cuda"


def test_prepare_data(tmp_path, capsys):
    rng = np.random.default_rng(0)
    for i in range(3):
        d = tmp_path / "pairs" / f"pair_{i:06d}"
        os.makedirs(d)
        tio.save_tiff16(rng.random((16, 16), dtype=np.float32),
                        str(d / "hubble.tiff"))
        tio.save_tiff16(rng.random((4, 4), dtype=np.float32),
                        str(d / "observatory.tiff"))
    main(["prepare-data", "--root", str(tmp_path / "pairs"),
          "--out", str(tmp_path / "splits"), "--mode", "overfit"])
    out = json.loads(capsys.readouterr().out)
    assert os.path.exists(out["train"])


def test_upscale_espcn_host_tiler(tmp_path, captured, capsys):
    src, dst = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    img = np.random.default_rng(1).random((12, 12), dtype=np.float32)
    save_png(img, src)
    main(["upscale", "--input", src, "--output", dst, "--scale", "2",
          "--model", "espcn", "--tile", "8", "--halo", "4",
          "--device", "cpu"])
    assert load_image(dst).shape == (24, 24, 1)
    assert "saved to" in capsys.readouterr().out
    assert np.isfinite(captured["out"]).all()


def test_upscale_missing_input_friendly_error(tmp_path, capsys):
    rc = main(["upscale", "--input", str(tmp_path / "nope.png"),
               "--output", str(tmp_path / "out.png"), "--model", "espcn",
               "--scale", "2", "--device", "cpu"])
    assert rc == 2
    assert "not found" in capsys.readouterr().err


def test_mesh_flags_above_one_raise(tmp_path, capsys):
    """In one process (a world of one), --mesh-data or --mesh-pipe 2 asks
    for a mesh larger than the world and raises with the reference's
    message; upscale --mesh-data refuses a --blend other than crop and a
    model outside the rrdbnet family first, as the reference does."""
    src = str(tmp_path / "in.png")
    save_png(np.zeros((8, 8), np.float32), src)
    up = ["upscale", "--input", src, "--output", str(tmp_path / "o.png"),
          "--scale", "2", "--mesh-data", "2", "--device", "cpu"]
    assert main(up + ["--model", "espcn", "--blend", "hann"]) == 2
    assert "--blend hann is not supported" in capsys.readouterr().err
    assert main(up + ["--model", "espcn"]) == 2
    assert "rrdbnet family" in capsys.readouterr().err
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        main(up + ["--model", "rrdbnet", "--tile", "8", "--halo", "2"])
    for flag, msg in (("--mesh-data", "mesh 2x1 needs 2 devices, have 1"),
                      ("--mesh-pipe", "mesh 1x2 needs 2 devices, have 1")):
        with pytest.raises(ValueError, match=msg):
            main(["train", "--preset", "srcnn_x2", "--workdir",
                  str(tmp_path / "t"), flag, "2", "--device", "cpu"])


def _astro_frames(root):
    """A pre-solved master frame and one observatory frame over it (the
    ETL's inputs; no plate solver needed)."""
    from superresolution_tpu_torch.astro import (
        TanWCS,
        reproject_bilinear,
        write_fits,
    )

    rng = np.random.default_rng(4)
    master = rng.random((64, 64)) * 0.5 + 0.5
    h_wcs = TanWCS(crval=(150.0, 2.0), crpix=(32.5, 32.5),
                   cd=((-1.4e-5, 0.0), (0.0, 1.4e-5)))
    o_wcs = TanWCS(crval=(150.0, 2.0), crpix=(8.5, 8.5),
                   cd=((-5.6e-5, 0.0), (0.0, 5.6e-5)))
    obs, _ = reproject_bilinear(master, h_wcs, o_wcs, (16, 16))
    for d in ("hst", "obs"):
        os.makedirs(os.path.join(root, d))
    write_fits(os.path.join(root, "hst", "hst_master.fits"),
               master.astype(np.float32), h_wcs.to_header())
    write_fits(os.path.join(root, "obs", "obs_0.fits"),
               np.nan_to_num(obs).astype(np.float32), o_wcs.to_header())


def test_astro_subcommands_match_jax(tmp_path, capsys, monkeypatch):
    """astro-register, astro-qc, astro-extract and astro-normalize on the
    same synthetic frames print the reference's JSON lines (its output
    directory swapped for the port's) and write the same FITS and TIFF
    bytes."""
    import filecmp

    monkeypatch.setenv("SRTPU_ASTAP", str(tmp_path / "no_astap"))
    monkeypatch.setenv("PATH", str(tmp_path))
    _astro_frames(str(tmp_path))
    outs = {}
    for who, fn in (("port", main), ("ref", jax_main)):
        d = str(tmp_path / who)
        steps = [
            ["astro-register", "--hubble-dir", str(tmp_path / "hst"),
             "--obs-dir", str(tmp_path / "obs"), "--out", f"{d}/reg",
             "--workers", "1"],
            ["astro-qc", "--registered-dir", f"{d}/reg", "--out",
             f"{d}/qc.png"],
            ["astro-extract", "--hubble", str(tmp_path / "hst" /
                                              "hst_master.fits"),
             "--obs-dir", str(tmp_path / "obs"), "--out", f"{d}/pairs",
             "--hr-size", "32", "--stride", "32", "--workers", "1"],
            ["astro-normalize", "--pairs", f"{d}/pairs", "--out",
             f"{d}/tiffs"]]
        lines = []
        for argv in steps:
            fn(argv)
            lines.append(capsys.readouterr().out.strip().replace(d, "D"))
        outs[who] = lines
    assert outs["port"] == outs["ref"]
    assert json.loads(outs["port"][0]) == {"hubble": 1, "observatory": 1,
                                           "dir": "D/reg"}
    assert outs["port"][1] == "QC overlay -> D/qc.png"
    assert json.loads(outs["port"][2])["pairs"] >= 1
    for sub in ("reg", "pairs", "tiffs"):
        for root, _, files in os.walk(tmp_path / "port" / sub):
            for f in files:
                if f.endswith((".fits", ".tiff")):
                    other = os.path.join(str(tmp_path / "ref"), os.path.relpath(
                        os.path.join(root, f), str(tmp_path / "port")))
                    assert filecmp.cmp(os.path.join(root, f), other,
                                       shallow=False), f


def test_train_tiny_then_finalize_and_show_result(tmp_path, capsys):
    wd = str(tmp_path / "run")
    main(["train", "--preset", "srcnn_x2", "--workdir", wd, "--epochs", "1",
          "--batch-size", "2", "--mesh-data", "1", "--device", "cpu"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["epochs"] == 1 and result["final_step"] >= 1
    main(["finalize", "--checkpoints", os.path.join(wd, "checkpoints"),
          "--out", str(tmp_path / "final")])
    assert "finalized" in capsys.readouterr().out
    params = load_params_for_inference(str(tmp_path / "final" / "best"),
                                       device="cpu")
    assert "conv1.weight" in params
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    save_png(np.zeros((8, 8, 3), np.float32), a)
    save_png(np.ones((16, 16, 3), np.float32), b)
    main(["show-result", "--images", a, b, "--output",
          str(tmp_path / "c.png"), "--labels", "Input,Result"])
    assert "collage" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "c.png")


def test_eval_folder(tmp_path, capsys):
    d = tmp_path / "set"
    os.makedirs(d)
    rng = np.random.default_rng(2)
    for i in range(2):
        save_png(rng.random((16, 16, 3), dtype=np.float32),
                 str(d / f"img_{i}.png"))
    main(["eval-folder", str(d), "--model", "espcn", "--scale", "2",
          "--tile", "8", "--halo", "4", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out)
    assert res["n"] == 2 and np.isfinite(res["psnr"])
    assert main(["eval-folder", str(tmp_path / "none"),
                 "--device", "cpu"]) == 2


def _basicsr_rrdbnet():
    return RRDBNet(scale=4, in_channels=3, out_channels=3, features=8,
                   num_blocks=2, growth=4, upsampler="nearest_conv",
                   device="cpu", generator=torch.Generator().manual_seed(3))


def test_import_reference_round_trip(tmp_path, captured, capsys):
    """A BasicSR-layout RRDBNet state dict, wrapped as BasicSR releases
    it, -> import-reference -> upscale --ckpt: the same output as
    api.upscale with the same weights."""
    ref = _basicsr_rrdbnet()
    sd = {k: v + 0.01 * torch.randn(v.shape,
                                     generator=torch.Generator()
                                     .manual_seed(4))
          for k, v in ref.state_dict().items()}
    pth = str(tmp_path / "esrgan.pth")
    torch.save({"params_ema": sd}, pth)
    out = str(tmp_path / "ck")
    main(["import-reference", "--pth", pth, "--out", out])
    info = json.loads(capsys.readouterr().out)
    assert info["model"] == "rrdbnet" and info["refiner"] is None
    with open(os.path.join(out, "model_config.json")) as f:
        cfg = json.load(f)
    assert cfg["scale"] == 4 and cfg["kwargs"] == {
        "features": 8, "num_blocks": 2, "growth": 4,
        "upsampler": "nearest_conv"}
    loaded = load_params_for_inference(info["checkpoint"], device="cpu")
    for k, v in sd.items():
        assert torch.equal(loaded[k], v), k

    src = str(tmp_path / "in.png")
    img = np.random.default_rng(5).random((12, 16, 3), dtype=np.float32)
    save_png(img, src)
    img = load_image(src)
    main(["upscale", "--input", src, "--output", str(tmp_path / "o.png"),
          "--ckpt", info["checkpoint"], "--tile", "8", "--halo", "4",
          "--device", "cpu"])
    want = api.upscale(img, 4, model=ref, params=sd, tile=8, halo=4,
                       device="cpu")
    assert captured["out"].shape == (48, 64, 3)
    np.testing.assert_allclose(captured["out"], want, atol=1e-3)


def test_detect_reference_config_matches_jax():
    from superresolution_tpu.models.convert import detect_and_import

    sd = {k: v.numpy() for k, v in _basicsr_rrdbnet().state_dict().items()}
    _, want = detect_and_import(sd)
    got = detect_reference_config(sd)
    assert got == json.loads(json.dumps(want))


def test_upscale_ckpt_anchor_matches_api(tmp_path, captured):
    """The committed checkpoint (an npz of the JAX tree) through the CLI
    and through api.upscale with the same weights: within 1e-3."""
    src = str(tmp_path / "in.png")
    save_png(np.random.default_rng(6).random((20, 24, 3), dtype=np.float32),
             src)
    img = load_image(src)
    main(["upscale", "--input", src, "--output", str(tmp_path / "o.png"),
          "--ckpt", ANCHOR, "--tile", "16", "--halo", "4",
          "--device", "cpu"])
    sd, cfg = load_params_for_inference(ANCHOR, with_config=True,
                                        device="cpu")
    model = RRDBNet(scale=cfg["scale"], in_channels=3, out_channels=3,
                    device="cpu", **cfg["kwargs"])
    want = api.upscale(img, cfg["scale"], model=model, params=sd, tile=16,
                       halo=4, device="cpu")
    assert captured["out"].shape == (80, 96, 3)
    np.testing.assert_allclose(captured["out"], want, atol=1e-3)


def test_upscale_fast_attn_binds_the_fused_rrdbnet(tmp_path, captured,
                                                   monkeypatch):
    """--fast-attn on an RRDBNet checkpoint: the prebound fused model
    (B1-B3 on the card; their plain versions here) reaches api.upscale."""
    from superresolution_tpu_torch.infer import fused_trunk

    bound = []
    real = fused_trunk.fused_rrdb_model

    def spy(params, model, device=None):
        bound.append(device)
        return real(params, model, device=device)

    monkeypatch.setattr(fused_trunk, "fused_rrdb_model", spy)
    src = str(tmp_path / "in.png")
    save_png(np.random.default_rng(7).random((16, 16, 3), dtype=np.float32),
             src)
    main(["upscale", "--input", src, "--output", str(tmp_path / "o.png"),
          "--ckpt", ANCHOR, "--fast-attn", "--tile", "16", "--halo", "4",
          "--device", "cpu"])
    assert bound == ["cpu"]
    fast = captured["out"]
    main(["upscale", "--input", src, "--output", str(tmp_path / "p.png"),
          "--ckpt", ANCHOR, "--tile", "16", "--halo", "4",
          "--device", "cpu"])
    assert fast.shape == captured["out"].shape == (64, 64, 3)
    np.testing.assert_allclose(fast, captured["out"], atol=0.03)


def test_upscale_fast_attn_raises_on_a_checkpoint_it_cannot_bind(
        tmp_path, capsys):
    """--fast-attn on an RRDBNet checkpoint that lacks one trunk conv:
    binding the fused model fails, and the command raises rather than
    running the plain model in its place."""
    pth = str(tmp_path / "esrgan.pth")
    torch.save({"params_ema": _basicsr_rrdbnet().state_dict()}, pth)
    out = str(tmp_path / "ck")
    main(["import-reference", "--pth", pth, "--out", out])
    ckpt = json.loads(capsys.readouterr().out)["checkpoint"]
    state = os.path.join(ckpt, "state.pt")
    tree = torch.load(state, weights_only=True)
    for k in ("params", "ema_params"):
        if tree.get(k) is not None:
            del tree[k]["body.1.rdb2.conv3.weight"]
    torch.save(tree, state)
    src = str(tmp_path / "in.png")
    save_png(np.random.default_rng(8).random((12, 12, 3), dtype=np.float32),
             src)
    with pytest.raises(KeyError, match="body.1.rdb2.conv3.weight"):
        main(["upscale", "--input", src, "--output",
              str(tmp_path / "o.png"), "--ckpt", ckpt, "--fast-attn",
              "--tile", "8", "--halo", "4", "--device", "cpu"])


def test_benchmark_needs_the_repository_root(monkeypatch, tmp_path,
                                             capsys):
    import sys

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "path", [p for p in sys.path
                                      if os.path.abspath(p or ".") !=
                                      os.path.abspath(os.path.join(
                                          ANCHOR, "..", "..", ".."))])
    monkeypatch.delitem(sys.modules, "chip_smoke", raising=False)
    with pytest.raises(SystemExit) as e:
        main(["benchmark"])
    assert e.value.code == 2
    assert "repository root" in capsys.readouterr().out


# ---- the remaining utils ----

def test_setup_kernel_cache_builds_nothing_on_the_cpu(monkeypatch):
    from superresolution_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "build", lambda: pytest.fail("built"))
    setup_kernel_cache("cpu")


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_finite_check_matches_jax():
    import jax.numpy as jnp

    ok = {"a": torch.ones(2), "b": {"c": torch.zeros(3)}}
    finite_check(ok)
    bad = {"a": np.ones(2, np.float32),
           "b": {"c": np.array([0.0, np.nan], np.float32)}}
    with pytest.raises(FloatingPointError) as je:
        jax_finite({k: jnp.asarray(v) if not isinstance(v, dict) else
                    {kk: jnp.asarray(vv) for kk, vv in v.items()}
                    for k, v in bad.items()}, "state")
    with pytest.raises(FloatingPointError) as te:
        finite_check({"a": torch.from_numpy(bad["a"]),
                      "b": {"c": torch.from_numpy(bad["b"]["c"])}}, "state")
    assert str(te.value) == str(je.value)
