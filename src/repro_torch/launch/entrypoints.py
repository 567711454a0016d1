"""Entry-point builders of the dry run. Port of
``repro/launch/entrypoints.py``.

For each input shape the traced function is:
  train_4k      -> train_step(params, opt_state, batch)
  prefill_32k   -> prefill_step(params, batch)
  decode_32k,
  long_500k     -> serve_step(params, tokens, cache)   (ONE new token)

:func:`build_lowering_spec` returns a :class:`LoweringSpec`: the function,
its arguments as meta tensors (shapes and dtypes, nothing allocated), and
the placements of its inputs and outputs as spec trees of
``core/disagg.P`` (the reference's ``NamedSharding`` trees), ready for
``launch/dryrun.py`` ``trace``. The functions take the mesh's device type,
so on a ``"cuda"`` mesh the hand-written kernels' faces are traced.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import INPUT_SHAPES, input_specs
from repro_torch.core import disagg
from repro_torch.core.disagg import P
from repro_torch.models import transformer
from repro_torch.models.common import (ModelConfig, is_placed,
                                       set_activation_constraint)
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import make_train_step
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class LoweringSpec:
    name: str
    fn: Callable
    args: Tuple           # meta-tensor trees
    in_shardings: Tuple   # spec trees, one per argument
    out_shardings: Any    # spec tree of the result
    cfg: ModelConfig
    donate: Tuple[int, ...] = ()   # donated arg indices (train: params+opt)


def resolve_config(arch: str, shape: str, *, unrolled: bool = False,
                   overrides: Optional[Dict] = None) -> ModelConfig:
    cfg = registry.config_for_shape(arch, shape)
    if unrolled:
        cfg = cfg.replace(lower_unrolled=True)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _unstack(tree):
    """(L, ...) meta subtree -> list of L per-layer subtrees, each leaf a
    buffer of its own (the production serving layout)."""
    n = tree_leaves(tree)[0].shape[0]
    return [tree_map(lambda a: _meta(a.shape[1:], a.dtype), tree)
            for _ in range(n)]


def unstack_params_shape(cfg: ModelConfig, params_shape):
    out = dict(params_shape)
    if cfg.family == "hybrid":
        out["layers"] = [_unstack(sup) for sup in _unstack(
            params_shape["layers"])]
        if "tail" in params_shape:
            out["tail"] = _unstack(params_shape["tail"])
    else:
        out["layers"] = _unstack(params_shape["layers"])
    if "enc_layers" in params_shape:
        out["enc_layers"] = _unstack(params_shape["enc_layers"])
    return out


def unstack_cache_shape(cfg: ModelConfig, cache_shape):
    out = {}
    for key, val in cache_shape.items():
        if key == "len":
            out[key] = val
        elif key in ("h", "conv") and cfg.family == "hybrid":
            out[key] = [_unstack(sup) for sup in _unstack(val)]
        else:
            out[key] = _unstack(val)
    return out


def install_activation_constraint(cfg: ModelConfig, mesh) -> None:
    """Megatron-style activation placement over the TP axis: a placed
    (B, S, d) residual or (B, X, S, d) fused-mixer activation is
    redistributed to batch over data (+pod, the axes that divide B) and
    hidden over ``model`` when the shards keep >= 128 columns, the
    reference's rule (its 128-lane register width; MoE activations follow
    it too). A tensor that is not placed, or of another rank, passes
    unchanged. Undo with ``set_activation_constraint(None)``."""
    from repro_torch.launch.mesh import mesh_axes
    ms = mesh_axes(mesh)
    baxes = disagg.batch_axes(mesh)

    def batch_axes_for(B):
        use, total = [], 1
        for a in baxes:
            if B % (total * ms[a]) == 0:
                use.append(a)
                total *= ms[a]
        return tuple(use) if use else None

    def spec_for(shape) -> P:
        dims = [batch_axes_for(shape[0])] + [None] * (len(shape) - 1)
        d = shape[-1]
        if d % ms["model"] == 0 and d // ms["model"] >= 128:
            dims[-1] = "model"
        return P(*dims)

    def constrain(x):
        if not is_placed(x) or x.ndim not in (3, 4):
            return x
        pl = disagg.placements(spec_for(tuple(x.shape)), x.device_mesh)
        if tuple(x.placements) == pl:
            return x
        return x.redistribute(x.device_mesh, pl)

    set_activation_constraint(constrain)


def _updates_shape(cfg: ModelConfig, cache_shape) -> Dict:
    """The structure ``decode_step`` returns beside its logits: the cache
    less its K/V (and scales, cross K/V), len, and k_new / v_new (the
    layers' new token, full precision) where the cache has K/V."""
    out = {k: v for k, v in cache_shape.items()
           if k not in ("k", "v", "ck", "cv", "k_scale", "v_scale")}
    if "k" in cache_shape:
        for key in ("k_new", "v_new"):
            out[key] = tree_map(
                lambda a: _meta(a.shape[:-2] + a.shape[-1:], cfg.dtype),
                cache_shape["k"])
    return out


def build_lowering_spec(arch: str, shape: str, mesh, *,
                        unrolled: bool = False,
                        overrides: Optional[Dict] = None,
                        attention_partition: str = "auto",
                        grad_accum: Optional[int] = None) -> LoweringSpec:
    cfg = resolve_config(arch, shape, unrolled=unrolled, overrides=overrides)
    # ZeRO/FSDP over `data` above 10B parameters (the reference's rule)
    from repro_torch.core.costmodel import param_count
    fsdp = param_count(cfg) > 10e9
    # the rank's device: the dry run traces rank 0, whose shards a CUDA
    # mesh of one process keeps on device 0
    device = torch.device(mesh.device_type,
                          0 if mesh.device_type == "cuda" else None)
    shp = INPUT_SHAPES[shape]
    if shp.kind in ("train", "prefill"):
        install_activation_constraint(cfg, mesh)
    specs = input_specs(cfg, shape)
    params_shape = transformer.init_params(0, cfg, device="meta")
    if unrolled:
        params_shape = unstack_params_shape(cfg, params_shape)
    pspecs = disagg.specs_for_params(cfg, params_shape, mesh, fsdp=fsdp)

    if shp.kind == "train":
        adamw = opt.AdamWConfig()
        if grad_accum is None:
            # memory pass: 8 microbatches (audio 16); the cost pass 1
            grad_accum = 1 if unrolled else (16 if cfg.family == "audio"
                                             else 8)
        step_fn = make_train_step(cfg, adamw, grad_accum=grad_accum)
        opt_shape = opt.init_opt_state(params_shape)
        ospecs = opt.OptState(step=P(), mu=pspecs, nu=pspecs)
        bspecs = disagg.specs_for_batch(cfg, specs["batch"], mesh)
        metric_specs = {"ce": P(), "aux": P(), "loss": P(),
                        "grad_norm": P(), "lr": P()}
        return LoweringSpec(
            name=f"{arch}:{shape}:train_step", fn=step_fn,
            args=(params_shape, opt_shape, specs["batch"]),
            in_shardings=(pspecs, ospecs, bspecs),
            out_shardings=(pspecs, ospecs, metric_specs),
            cfg=cfg, donate=(0, 1))

    if shp.kind == "prefill":
        batch = specs["batch"]
        B = shp.global_batch
        max_seq = batch["tokens"].shape[1]
        if cfg.modality == "vision":
            max_seq += batch["frontend"].shape[1]

        def prefill_step(params, batch):
            return transformer.prefill(params, cfg, batch, max_seq=max_seq,
                                       device=device)

        bspecs = disagg.specs_for_batch(cfg, batch, mesh)
        cache_shape = transformer.init_cache(cfg, B, max_seq, device="meta")
        if cfg.family == "audio":     # cross K/V over every encoded frame
            kv = (cfg.num_layers, B, cfg.num_kv_heads,
                  batch["frames"].shape[1], cfg.resolved_head_dim)
            cache_shape["ck"] = _meta(kv, cfg.dtype)
            cache_shape["cv"] = _meta(kv, cfg.dtype)
        if unrolled:
            cache_shape = unstack_cache_shape(cfg, cache_shape)
        cspecs = disagg.specs_for_cache(cfg, cache_shape, mesh,
                                        attention_partition)
        logits_sp = disagg.logits_spec(cfg, mesh, B)
        return LoweringSpec(
            name=f"{arch}:{shape}:prefill_step", fn=prefill_step,
            args=(params_shape, batch), in_shardings=(pspecs, bspecs),
            out_shardings=(logits_sp, cspecs), cfg=cfg)

    # decode
    def serve_step(params, tokens, cache):
        return transformer.decode_step(params, cfg, tokens, cache,
                                       device=device)

    cache_shape = specs["cache"]
    if unrolled:
        cache_shape = unstack_cache_shape(cfg, cache_shape)
    cspecs = disagg.specs_for_cache(cfg, cache_shape, mesh,
                                    attention_partition)
    tok_spec = disagg.specs_for_batch(
        cfg, {"tokens": specs["tokens"]}, mesh)["tokens"]
    logits_sp = disagg.logits_spec(cfg, mesh, shp.global_batch)
    uspecs = disagg.specs_for_cache(cfg, _updates_shape(cfg, cache_shape),
                                    mesh, attention_partition)
    return LoweringSpec(
        name=f"{arch}:{shape}:serve_step", fn=serve_step,
        args=(params_shape, specs["tokens"], cache_shape),
        in_shardings=(pspecs, tok_spec, cspecs),
        out_shardings=(logits_sp, uspecs), cfg=cfg)
