"""Carry the JAX package's parameters into the port.

:func:`params_from_jax` takes the reference's parameter pytree as nested
dicts and lists of numpy arrays (``jax.tree.map(np.asarray, params)``; this
module imports no JAX) and builds the port's module with the same weights,
so both packages then compute the same function.  A quantized reference
weight arrives as the plain dict ``{"q", "scale", "act_scale", "axis",
"dtype_name", "bits", "pack_size"}`` with numpy children and becomes a
``QuantizedTensor``, so a JAX-quantized and JAX-calibrated pytree runs in
the port unchanged.

:func:`lm_params_from_jax` does the same for the reference's LM pytree,
whose stages hold each layer's weights stacked along a leading layer axis
(the reference scans over them): it slices layer ``i`` out of every
stacked leaf, a stacked quantized weight included (int4: ``q`` of shape
``(L, ceil(K/2), N)``, ``scale`` ``(L, 1, N)``, ``pack_size`` kept), into
the port's one module per layer.  An MoE block's ``router (L, d, E)`` and
expert weights ``(L, E, d, f)`` (quantized ones too: ``q`` ``(L, E,
ceil(d/2), f)`` in int4, ``scale`` ``(L, E, 1, f)``) are sliced the same
way, with its ``shared`` MLP where the config has one.  An MLA layer's
``q_a``, ``q_a_norm``, ``q_b``, ``kv_a``, ``kv_a_norm``, ``kv_b`` and ``wo``
are sliced likewise, and a DeepSeek-V3 tree's unstacked ``mtp`` subtree
(``proj``, one dense MLA ``block``, ``norm``) becomes the port's
``transformer.MTP``.  An SSM layer's ``ln1`` and ``mixer`` (Mamba-1's
``in_proj`` ... ``out_proj``, Mamba-2's split ``in_z`` / ``in_x`` /
``in_b`` / ``in_c`` / ``in_dt`` projections, convs, ``norm`` and
``out_proj``) become ``models.ssm``'s mixers, a hybrid stage's unstacked
``shared`` subtree its ``transformer.SharedAttn``; a tied tree has no
``lm_head``.

A meshed engine (``ServeEngine(mesh=)``) takes the model these build, whole,
and keeps its rank's blocks, as the reference's ``device_put`` does: every
rank converts the same numpy tree.

:func:`caches_from_jax` carries the reference's LM caches across the same
way (dense slot caches, a windowed layer's rolling buffer, an MLA
layer's latent cache, an SSM layer's conv and SSM state and a hybrid
stage's shared attention cache among them, or paged ones with their
pools, scale pools, counters and page table), so
that one step of both packages can start from the same cache state.

:func:`train_state_from_jax` carries a reference training state across:
its parameters as :func:`lm_params_from_jax` carries them, the AdamW
moments ``mu`` / ``nu`` (and a gradient-compression residual) leaf for
leaf under the port's parameter names, and the step counters, so that a
train step of both packages can start from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as LL
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as TT
from repro_torch.quant.qtensor import QuantizedTensor
from repro_torch.serve import kvcache as KV
from repro_torch.train.train_step import trainable
from repro_torch.vision import blocks as B
from repro_torch.vision import models as M


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.array(a))


def _weight(a) -> torch.Tensor | QuantizedTensor:
    if isinstance(a, dict):
        return QuantizedTensor.from_numpy(a)
    return _tensor(a)


def _conv(p: dict) -> B.ConvBN:
    return B.ConvBN(_weight(p["w"]), _tensor(p["b"]))


def _dense(p: dict) -> B.Dense:
    return B.Dense(_weight(p["w"]), _tensor(p["b"]))


def _pair(p: dict) -> M.ConvPair:
    return M.ConvPair(_conv(p["a"]), _conv(p["b"]))


def _yolo_head(p: dict) -> M.YoloHead:
    return M.YoloHead([_pair(q) for q in p["pairs"]], _conv(p["det"]))


def _resnet(tree: dict, cfg: M.VisionConfig) -> M.ResNet:
    stages = [[B.Bottleneck(_conv(blk["conv1"]), _conv(blk["conv2"]),
                            _conv(blk["conv3"]),
                            _conv(blk["down"]) if "down" in blk else None)
               for blk in stage] for stage in tree["stages"]]
    return M.ResNet(cfg, _conv(tree["stem"]), stages, _dense(tree["head"]))


def _mobilenet(tree: dict, cfg: M.VisionConfig) -> M.MobileNet:
    blocks = [B.DWSeparable(_conv(b["dw"]), _conv(b["pw"]))
              for b in tree["blocks"]]
    return M.MobileNet(cfg, _conv(tree["stem"]), blocks,
                       _dense(tree["head"]))


def _yolov3_tiny(tree: dict, cfg: M.VisionConfig) -> M.YOLOv3Tiny:
    return M.YOLOv3Tiny(cfg, [_conv(p) for p in tree["backbone"]],
                        *(_conv(tree[k]) for k in ("conv7", "neck", "head1",
                                                   "det1", "up", "head2",
                                                   "det2")))


def _yolov3(tree: dict, cfg: M.VisionConfig) -> M.YOLOv3:
    stages = [M.DarknetStage(_conv(s["down"]), [_pair(r) for r in s["res"]])
              for s in tree["stages"]]
    return M.YOLOv3(cfg, _conv(tree["stem"]), stages,
                    _yolo_head(tree["head1"]), _conv(tree["up1"]),
                    _yolo_head(tree["head2"]), _conv(tree["up2"]),
                    _yolo_head(tree["head3"]))


_FROM_TREE = {"resnet": _resnet, "mobilenet_v1": _mobilenet,
              "yolov3_tiny": _yolov3_tiny, "yolov3": _yolov3}


def params_from_jax(tree: dict, cfg: M.VisionConfig, *,
                    device=None) -> torch.nn.Module:
    """The port's model for ``cfg`` holding the weights of ``tree`` (a
    reference pytree of numpy arrays), on ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    return _FROM_TREE[cfg.arch](tree, cfg).to(dev)


def _layer(a, i: int):
    """Layer ``i`` of a stacked leaf: an array, or a quantized weight's
    dict (its ``act_scale`` sliced too when it is per layer)."""
    if isinstance(a, dict):
        act = a.get("act_scale")
        return dict(a, q=np.asarray(a["q"])[i],
                    scale=np.asarray(a["scale"])[i],
                    act_scale=None if act is None else np.asarray(act)[i])
    return np.asarray(a)[i]


def _stacked(tree):
    """An unstacked subtree (the MTP head's) with a layer axis of 1 on
    every array and quantized payload, so that :func:`_layer` slices it
    as it slices a stage's leaves."""
    if isinstance(tree, dict) and "q" in tree and "scale" in tree:
        act = tree.get("act_scale")
        return dict(tree, q=np.asarray(tree["q"])[None],
                    scale=np.asarray(tree["scale"])[None],
                    act_scale=None if act is None else np.asarray(act)[None])
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return np.asarray(tree)[None]


_MAMBA1 = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
           "A_log", "D", "out_proj")
_MAMBA2 = ("in_z", "in_x", "in_b", "in_c", "in_dt", "conv_x_w", "conv_x_b",
           "conv_b_w", "conv_b_b", "conv_c_w", "conv_c_b", "dt_bias",
           "A_log", "D")


def _gqa(attn: dict, i: int, cfg: ModelConfig) -> LL.Attention:
    w = lambda k: _weight(_layer(attn[k], i))               # noqa: E731
    biases = tuple(_tensor(_layer(attn[k], i))
                   for k in ("bq", "bk", "bv")) if cfg.qkv_bias else ()
    return LL.Attention(w("wq"), w("wk"), w("wv"), w("wo"), *biases)


def _lm_block(layers: dict, i: int, cfg: ModelConfig,
              stage) -> TT.Block | TT.SSMBlock:
    w = lambda d, k: _weight(_layer(d[k], i))               # noqa: E731
    norm = lambda d: LL.RMSNorm(                            # noqa: E731
        _tensor(_layer(d["scale"], i)))
    if stage.block == "mamba1":
        m = layers["mixer"]
        return TT.SSMBlock(norm(layers["ln1"]),
                           SSM.Mamba1(*(w(m, k) for k in _MAMBA1)))
    if stage.block in ("mamba2", "hybrid"):
        m = layers["mixer"]
        return TT.SSMBlock(norm(layers["ln1"]), SSM.Mamba2(
            *(w(m, k) for k in _MAMBA2), norm(m["norm"]),
            w(m, "out_proj")))
    attn, ffn = layers["attn"], layers["ffn"]
    mlp = lambda d: LL.MLP(w(d, "w_gate"), w(d, "w_up"),    # noqa: E731
                           w(d, "w_down"))
    if stage.attn == "mla":
        attn_mod = MLA.MLA(w(attn, "q_a"), norm(attn["q_a_norm"]),
                           w(attn, "q_b"), w(attn, "kv_a"),
                           norm(attn["kv_a_norm"]), w(attn, "kv_b"),
                           w(attn, "wo"))
    else:
        attn_mod = _gqa(attn, i, cfg)
    if stage.block == "moe":
        ffn_mod = MOE.MoE(_tensor(_layer(ffn["router"], i)),
                          w(ffn, "w_gate"), w(ffn, "w_up"), w(ffn, "w_down"),
                          mlp(ffn["shared"]) if "shared" in ffn else None)
    else:
        ffn_mod = mlp(ffn)
    return TT.Block(norm(layers["ln1"]), attn_mod, norm(layers["ln2"]),
                    ffn_mod)


def lm_params_from_jax(tree: dict, cfg: ModelConfig, *,
                       device=None) -> TT.LM:
    """The port's LM for ``cfg`` holding the weights of ``tree`` (the
    reference's LM pytree of numpy arrays), on ``device`` (None: CUDA)."""
    dev = resolve_device(device)

    def shared(p_s: dict) -> TT.SharedAttn | None:
        if "shared" not in p_s:
            return None
        sh = p_s["shared"]
        norm = lambda d: LL.RMSNorm(_tensor(d["scale"]))  # noqa: E731
        return TT.SharedAttn(
            norm(sh["ln1"]), _gqa(_stacked(sh["attn"]), 0, cfg),
            norm(sh["ln2"]), LL.MLP(*(_weight(sh["mlp"][k])
                                      for k in ("w_gate", "w_up",
                                                "w_down"))))

    stages = [TT.Stage([_lm_block(p_s["layers"], i, cfg, s)
                        for i in range(s.n_layers)], shared(p_s))
              for p_s, s in zip(tree["stages"], cfg.stages, strict=True)]
    mtp = None
    if cfg.mtp:
        m = tree["mtp"]
        mtp = TT.MTP(_weight(m["proj"]),
                     _lm_block(_stacked(m["block"]), 0, cfg, TT.MTP_STAGE),
                     LL.RMSNorm(_tensor(m["norm"]["scale"])))
    return TT.LM(cfg, _tensor(tree["embed"]), stages,
                 LL.RMSNorm(_tensor(tree["final_norm"]["scale"])),
                 None if cfg.tie_embeddings else _weight(tree["lm_head"]),
                 mtp).to(dev)


def _array(a) -> torch.Tensor:
    """A numpy array as a tensor of its dtype; bfloat16 and e4m3 arrays
    (numpy's ``ml_dtypes``) through their bits."""
    a = np.asarray(a)
    bits = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8}.get(
        a.dtype.name)
    if bits is None:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(bits).copy()).view(
        getattr(torch, a.dtype.name))


def caches_from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> dict:
    """The port's LM caches holding the reference's ``tree`` (its caches
    pytree of numpy arrays, each stage's layer leaves stacked along a
    leading layer axis), on ``device`` (None: CUDA).  A paged tree (one
    with a ``page_table``) keeps its pools, scale pools, counters and
    table; each pool gains the port's zero sink page at its end."""
    dev = resolve_device(device)

    def leaf(name: str, a) -> torch.Tensor:
        t = _array(a)
        if name.endswith(KV.PAGED_LEAF_SUFFIXES):
            t = torch.cat([t, torch.zeros_like(t[:1])])
        return t.to(dev)

    def stage(c_s: dict, s) -> dict:
        out = {"layers": [
            {part: {name: leaf(name, a[i]) for name, a in leaves.items()}
             for part, leaves in c_s["layers"].items()}
            for i in range(s.n_layers)]}
        if "shared" in c_s:
            out["shared"] = {name: _array(a).to(dev)
                             for name, a in c_s["shared"].items()}
        return out

    caches = {
        "pos": _array(tree["pos"]).to(dev),
        "stages": [stage(c_s, s)
                   for c_s, s in zip(tree["stages"], cfg.stages, strict=True)],
    }
    if KV.PAGE_TABLE_KEY in tree:
        caches[KV.PAGE_TABLE_KEY] = _array(tree[KV.PAGE_TABLE_KEY]).to(dev)
    return caches


def train_state_from_jax(state: dict, cfg: ModelConfig, *,
                         device=None) -> dict:
    """The port's training state (``train.train_step``'s layout) holding
    the reference's ``state`` (its training state pytree of numpy arrays),
    on ``device`` (None: CUDA).  Each params-shaped tree (the moments, a
    compression residual) is keyed by the port's parameter names: it goes
    through :func:`lm_params_from_jax` as parameters would."""
    dev = resolve_device(device)

    def named(tree: dict) -> dict:
        lm = lm_params_from_jax(tree, cfg, device=dev)
        return {n: p.detach() for n, p in lm.named_parameters()}

    out = {"params": trainable(lm_params_from_jax(state["params"], cfg,
                                                  device=dev)),
           "opt": {"mu": named(state["opt"]["mu"]),
                   "nu": named(state["opt"]["nu"]),
                   "step": _array(state["opt"]["step"]).to(dev)},
           "step": _array(state["step"]).to(dev)}
    if "ef_error" in state:
        out["ef_error"] = named(state["ef_error"])
    return out
