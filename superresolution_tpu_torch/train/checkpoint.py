"""Checkpoints with best/last promotion and resume.

Counterpart of superresolution_tpu/train/checkpoint.py:19-145 and
186-201, with the same directory layout: step_{step:010d}/ per saved
step, meta.json (best_step, best_psnr, last_step), model_config.json,
the best step kept by PSNR, at most `keep` steps, `finalize` copying
best (else last) into out_dir/best and checking it with a probe
(params_probe). A step directory holds state.pt, torch.save of the
train state's tree (step, params, opt_state, ema_params) on the host; it
is written to a temporary directory and renamed, so an interrupted save
leaves no partial step and `restore` falls back to the newest whole one.
save(block=False) copies the state to the host before it returns and
writes it on a background thread, at most one save in flight; wait()
commits it, and restore, finalize and the next save wait first.

load_params_for_inference (train/checkpoint.py:148-183 there) reads the
weights alone for inference: from such a directory, from a finalized
best/ directory, or from an export of a JAX checkpoint (params.npz with
'/'-joined tree paths beside model_config.json, written by
tools/export_params_npz.py), which models/convert.py bridges.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

from superresolution_tpu_torch.runtime import resolve_device
from superresolution_tpu_torch.train.state import TrainState


def _to(tree, device, copy: bool = False):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=copy)
    if isinstance(tree, dict):
        return {k: _to(v, device, copy) for k, v in tree.items()}
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 model_config: dict | None = None):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.keep = keep
        self._writer: threading.Thread | None = None
        self._write_error: BaseException | None = None
        self._meta_path = os.path.join(self.dir, "meta.json")
        self.meta = {"best_step": None, "best_psnr": float("-inf"),
                     "last_step": None}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)
        # the architecture beside the weights, so inference can rebuild
        # the model from the checkpoint directory alone
        self._cfg_path = os.path.join(self.dir, "model_config.json")
        if model_config is not None:
            with open(self._cfg_path, "w") as f:
                json.dump(model_config, f, indent=2)

    def _save_meta(self) -> None:
        with open(self._meta_path, "w") as f:
            json.dump(self.meta, f, indent=2)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _write(self, tree: dict, step: int) -> None:
        path = self._step_dir(step)
        tmp = tempfile.mkdtemp(prefix=f"step_{step:010d}.tmp-", dir=self.dir)
        torch.save(tree, os.path.join(tmp, "state.pt"))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)

    def _write_async(self, tree: dict, step: int) -> None:
        try:
            self._write(tree, step)
        except BaseException as e:  # re-raised by wait()
            self._write_error = e

    def save(self, state: TrainState, step: int, psnr: float | None = None,
             block: bool = True) -> bool:
        """Save `state` at `step`; returns True if it is the new best by
        PSNR. With block=False the host copy of the state is taken before
        this returns (the next step may update the state in place) and
        the disk write runs on a background thread while training goes
        on; a later save, wait(), restore or finalize waits for it."""
        self.wait()
        tree = _to(state.state_dict(), "cpu", copy=True)
        if block:
            self._write(tree, step)
        else:
            self._writer = threading.Thread(
                target=self._write_async, args=(tree, step),
                name=f"ckpt-step-{step}", daemon=True)
            self._writer.start()
        self.meta["last_step"] = step
        is_best = False
        if psnr is not None and psnr > self.meta.get("best_psnr",
                                                     float("-inf")):
            self.meta["best_psnr"] = psnr
            self.meta["best_step"] = step
            is_best = True
        self._save_meta()
        self._gc()
        return is_best

    def wait(self) -> None:
        """Block until any in-flight async save has committed; raise its
        error if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        protected = {self.meta.get("best_step"), self.meta.get("last_step")}
        removable = [s for s in steps if s not in protected]
        while len(removable) > max(0, self.keep - len(protected)):
            shutil.rmtree(self._step_dir(removable.pop(0)),
                          ignore_errors=True)

    def all_steps(self) -> list[int]:
        # exact step_NNNN directories only, not the temporary ones
        return sorted(int(d[5:]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and d[5:].isdigit())

    def restore(self, target: TrainState,
                step: int | None = None) -> TrainState | None:
        """The saved state at `step` (default: the last whole one) on
        `target`'s device, or None if there is none."""
        self.wait()
        if step is None:
            committed = self.all_steps()
            last = self.meta.get("last_step")
            step = (last if last in committed
                    else (committed[-1] if committed else None))
        if step is None or not os.path.exists(self._step_dir(step)):
            return None
        device = next(iter(target.params.values())).device
        tree = torch.load(os.path.join(self._step_dir(step), "state.pt"),
                          map_location="cpu", weights_only=True)
        tree = _to(tree, device)
        return TrainState(step=tree["step"], params=tree["params"],
                          opt_state=tree["opt_state"],
                          ema_params=tree["ema_params"])

    def restore_best(self, target: TrainState) -> TrainState | None:
        """The best step's state (else the last's), as restore gives it."""
        best = self.meta.get("best_step")
        return self.restore(target, step=best)

    def finalize(self, out_dir: str, probe=None) -> str:
        """Copy best (else last) to out_dir/best with model_config.json,
        then call probe(out_dir/best) if given (params_probe: the
        reference's structural check of the promoted weights)."""
        self.wait()
        step = self.meta.get("best_step")
        if step is None:  # explicit: `or` would skip a best_step of 0
            step = self.meta.get("last_step")
        if step is None:
            raise FileNotFoundError("no checkpoints to finalize")
        dst = os.path.join(out_dir, "best")
        os.makedirs(out_dir, exist_ok=True)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(self._step_dir(step), dst)
        if os.path.exists(self._cfg_path):
            shutil.copy(self._cfg_path,
                        os.path.join(out_dir, "model_config.json"))
        if probe is not None:
            probe(dst)
        return dst


def params_probe(expected_key_path: str):
    """-> probe(path) raising KeyError unless the checkpoint directory at
    `path` holds `expected_key_path`, a '/'-joined path into its saved
    tree (e.g. 'params/stage1.conv_first.weight': the port's parameter
    names are the state dict's)."""

    def _probe(path: str) -> None:
        node = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                          weights_only=True)
        for part in expected_key_path.split("/"):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(
                    f"finalized checkpoint missing {expected_key_path!r}")
            node = node[part]

    return _probe


def _unflatten(flat) -> dict:
    """{'a/b/c': array} -> nested dicts."""
    tree: dict = {}
    for key in flat:
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = flat[key]
    return tree


def _stage_state_dict(name: str, kw: dict, tree) -> dict:
    """One JAX model tree -> the port's numpy state dict."""
    from superresolution_tpu_torch.models import convert

    if name == "rrdbnet":
        return convert.rrdbnet_state_dict_from_jax(
            tree, num_blocks=kw.get("num_blocks", 23),
            features=kw.get("features", 64), growth=kw.get("growth", 32))
    if name == "hat_lite":
        return convert.hat_state_dict_from_jax(
            tree, depths=tuple(kw.get("depths", (6, 6, 6, 6))),
            hat_compat=kw.get("hat_compat", False))
    bridges = {"edsr": convert.edsr_state_dict_from_jax,
               "espcn": convert.espcn_state_dict_from_jax,
               "fsrcnn": convert.fsrcnn_state_dict_from_jax,
               "srcnn": convert.srcnn_state_dict_from_jax}
    if name not in bridges:
        raise KeyError(f"unknown model {name!r}")
    return bridges[name](tree)


def state_dict_from_jax_tree(tree, cfg: dict) -> dict:
    """A JAX parameter tree (a HybridSR's stage1/stage2, or one model's)
    and its model_config dict -> the port's numpy state dict."""
    tree = tree.get("params", tree)
    if "stage1" not in tree:
        return _stage_state_dict(cfg["name"], cfg.get("kwargs", {}), tree)
    sd = {f"stage1.{k}": v for k, v in _stage_state_dict(
        cfg["name"], cfg.get("kwargs", {}), tree["stage1"]).items()}
    if "stage2" in tree:
        sd.update({f"stage2.{k}": v for k, v in _stage_state_dict(
            cfg["refiner"], cfg.get("refiner_kwargs", {}),
            tree["stage2"]).items()})
    return sd


def _read_config(*dirs: str) -> dict | None:
    for d in dirs:
        path = os.path.join(d, "model_config.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    return None


def load_params_for_inference(ckpt_dir: str, prefer_ema: bool = True,
                              with_config: bool = False,
                              device: str | torch.device | None = None):
    """The model's weights (EMA if present and prefer_ema) as the port's
    f32 state dict on `device` (default cuda; raises without a GPU unless
    device='cpu'), from
      * a CheckpointManager directory (its best step, else its last);
      * a step or finalized best/ directory holding state.pt;
      * a directory holding params.npz (a JAX tree, '/'-joined keys) and
        model_config.json, converted through models/convert.py.
    model_config.json is read from the directory or its parent; with
    with_config=True returns (state_dict, config dict or None)."""
    dev = resolve_device(device)
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = ckpt_dir
    if os.path.exists(os.path.join(ckpt_dir, "meta.json")):
        mgr = CheckpointManager(ckpt_dir)
        step = mgr.meta.get("best_step")
        if step is None:  # explicit: `or` would skip a best_step of 0
            step = mgr.meta.get("last_step")
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        path = mgr._step_dir(step)
    cfg = _read_config(ckpt_dir, os.path.dirname(ckpt_dir))
    npz = os.path.join(path, "params.npz")
    if os.path.exists(npz):
        if cfg is None:
            raise FileNotFoundError(f"{npz} needs a model_config.json")
        with np.load(npz) as z:
            sd = state_dict_from_jax_tree(_unflatten(z), cfg)
        params = {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
                  for k, v in sd.items()}
    else:
        tree = torch.load(os.path.join(path, "state.pt"), map_location=dev,
                          weights_only=True)
        params = (tree["ema_params"]
                  if prefer_ema and tree.get("ema_params") is not None
                  else tree["params"])
    return (params, cfg) if with_config else params
