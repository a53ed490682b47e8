"""JAX weights -> the port's state_dict.

`state_dict_from_jax(params, batch_stats, family, effnet_variant, **flags)`
takes the JAX package's `{params, batch_stats}` tree of a model as numpy
arrays and returns the port's `state_dict`: conv kernels HWIO -> OIHW (a
depthwise (k, k, 1, C) kernel becomes (C, 1, k, k) by the same transpose),
dense kernels (in, out) -> (out, in), separate q/k/v projections re-packed
into `in_proj_weight` / `in_proj_bias`, batch-norm scale/bias/mean/var ->
weight/bias/running_mean/running_var. It inverts the JAX package's torch
porter for the five model families and for `VoVNetSimple` (family
"vovnet_simple", the backbone alone) and carries its own mapping. The
porter has no rule for `vovnet_pretrain`; its four components take the
flagship's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..nn.efficientnet import trunk_blocks
from ..nn.vovnet import TIMM_CONFIGS, VoVNetSimple

Tree = Dict[str, Any]


class _Rules:
    """(jax path, torch key, kind) triples for one model configuration."""

    def __init__(self):
        self.rules: List[Tuple[str, str, str]] = []

    def conv(self, jax: str, torch_key: str, bias: bool = False):
        self.rules.append((f"{jax}/kernel", f"{torch_key}.weight", "conv"))
        if bias:
            self.rules.append((f"{jax}/bias", f"{torch_key}.bias", "copy"))

    def bn(self, jax: str, torch_key: str):
        self.rules += [
            (f"{jax}/scale", f"{torch_key}.weight", "copy"),
            (f"{jax}/bias", f"{torch_key}.bias", "copy"),
            (f"{jax}/mean", f"{torch_key}.running_mean", "stat"),
            (f"{jax}/var", f"{torch_key}.running_var", "stat"),
            ("", f"{torch_key}.num_batches_tracked", "count"),
        ]

    def conv_bn(self, jax: str, torch_conv: str, torch_bn: str, bias: bool = False):
        self.conv(f"{jax}/conv", torch_conv, bias)
        self.bn(f"{jax}/bn", torch_bn)

    def linear(self, jax: str, torch_key: str):
        self.rules.append((f"{jax}/kernel", f"{torch_key}.weight", "linear"))
        self.rules.append((f"{jax}/bias", f"{torch_key}.bias", "copy"))

    def layernorm(self, jax: str, torch_key: str):
        self.rules.append((f"{jax}/scale", f"{torch_key}.weight", "copy"))
        self.rules.append((f"{jax}/bias", f"{torch_key}.bias", "copy"))

    def copy(self, jax: str, torch_key: str):
        self.rules.append((jax, torch_key, "copy"))

    def mha(self, jax: str, torch_key: str):
        self.rules.append((jax, f"{torch_key}.in_proj_weight", "inproj_w"))
        self.rules.append((jax, f"{torch_key}.in_proj_bias", "inproj_b"))
        self.linear(f"{jax}/out_proj", f"{torch_key}.out_proj")


def _aspp(r: _Rules, jax: str, t: str):
    r.conv_bn(f"{jax}/conv1x1", f"{t}.convs.0.0", f"{t}.convs.0.1")
    for i in range(3):
        r.conv_bn(f"{jax}/aspp{i}/conv", f"{t}.convs.{i + 1}.0", f"{t}.convs.{i + 1}.1")
    r.conv_bn(f"{jax}/pool_conv", f"{t}.convs.4.1", f"{t}.convs.4.2")
    r.conv_bn(f"{jax}/project", f"{t}.project.0", f"{t}.project.1")


def _up(r: _Rules, jax: str, torch_key: str):
    r.conv_bn(f"{jax}/conv1", f"{torch_key}.conv.0", f"{torch_key}.conv.1")
    r.conv_bn(f"{jax}/conv2", f"{torch_key}.conv.3", f"{torch_key}.conv.4")


def _lss_rules(r: _Rules, jax: str, variant: str):
    """LSS's modules under the JAX prefix `jax` ("" or "lss/"); the port
    holds them at the top level in every Stack A family."""
    t = "encoder.trunk"
    r.conv_bn(f"{jax}encoder/trunk/stem", f"{t}._conv_stem", f"{t}._bn0")
    for idx, (_, _, expand, *_rest) in enumerate(trunk_blocks(variant)[2]):
        jb, tb = f"{jax}encoder/trunk/block{idx}", f"{t}._blocks.{idx}"
        if expand != 1:
            r.conv_bn(f"{jb}/expand", f"{tb}._expand_conv", f"{tb}._bn0")
        r.conv_bn(f"{jb}/depthwise", f"{tb}._depthwise_conv", f"{tb}._bn1")
        r.conv(f"{jb}/se_reduce", f"{tb}._se_reduce", bias=True)
        r.conv(f"{jb}/se_expand", f"{tb}._se_expand", bias=True)
        r.conv_bn(f"{jb}/project", f"{tb}._project_conv", f"{tb}._bn2")
    _up(r, f"{jax}encoder/up1", "encoder.up1")
    r.conv(f"{jax}camencode/depthnet", "camencode.depthnet", bias=True)
    j, t = f"{jax}bevencode", "bevencode"
    r.conv_bn(f"{j}/conv1", f"{t}.conv1", f"{t}.bn1")
    for layer in (1, 2, 3):
        for i in range(2):
            jb, tb = f"{j}/layer{layer}_{i}", f"{t}.layer{layer}.{i}"
            r.conv_bn(f"{jb}/conv1", f"{tb}.conv1", f"{tb}.bn1")
            r.conv(f"{jb}/conv2", f"{tb}.conv2")
            r.bn(f"{jb}/bn2", f"{tb}.bn2")
            if layer > 1 and i == 0:
                r.conv_bn(f"{jb}/downsample", f"{tb}.downsample.0", f"{tb}.downsample.1")
    _up(r, f"{j}/up1", f"{t}.up1")
    r.conv_bn(f"{j}/up2_conv", f"{t}.up2.1", f"{t}.up2.2")
    r.conv(f"{j}/up2_out", f"{t}.up2.4", bias=True)


def _stack_a_rules(family: str, variant: str) -> _Rules:
    r = _Rules()
    _lss_rules(r, "" if family == "lss" else "lss/", variant)
    if family == "lss":
        return r
    r.conv_bn("bevpost/conv", "bevpost.post.0", "bevpost.post.1")
    if family == "bev_txt_onlybev":
        r.linear("embeder_bev/fc", "embeder_bev.1")
        r.linear("predictor_bev1/fc", "predictor_bev1.0")
        r.linear("predictor_bev2/fc", "predictor_bev2.0")
        return r
    _aspp(r, "sceneunder/aspp", "sceneunder.0")
    for name in ("embeder_f1", "embeder_lr1"):
        r.conv_bn(f"{name}/conv", f"{name}.0", f"{name}.1")
    for name in ("embeder_f2", "embeder_lr2"):
        r.linear(f"{name}/fc", f"{name}.1")
    for head in ("predictorf1", "predictorf2", "predictorlr"):
        r.linear(f"{head}/fc", f"{head}.0")
    return r


def _seq(r: _Rules, jax: str, torch_key: str):
    """ConvBN with a biased conv <- Sequential(conv, bn, ReLU)."""
    r.conv(f"{jax}/conv", f"{torch_key}.0", bias=True)
    r.bn(f"{jax}/bn", f"{torch_key}.1")


def _bev_branch_rules(r: _Rules, model_name: str = "vovnet39", lss_version: str = "v2"):
    """The flagship's BEV branch, the pretrain model's whole: `backbone`,
    `depth_net`, `cam_encode`, `bev_encoder`."""
    stem_chs, _, _, layers, blocks = TIMM_CONFIGS[model_name]
    for i in range(len(stem_chs)):
        r.conv_bn(f"backbone/stem{i}", f"backbone.backbone.stem.{i}.conv",
                  f"backbone.backbone.stem.{i}.bn")
    for s in range(4):
        for b in range(blocks[s]):
            jb, tb = f"backbone/stage{s + 1}_block{b}", f"backbone.backbone.stages.{s}.blocks.{b}"
            for i in range(layers):
                r.conv_bn(f"{jb}/conv{i}", f"{tb}.conv_mid.{i}.conv", f"{tb}.conv_mid.{i}.bn")
            r.conv_bn(f"{jb}/concat_conv", f"{tb}.conv_concat.conv", f"{tb}.conv_concat.bn")
            r.conv(f"{jb}/ese/fc", f"{tb}.attn.fc", bias=True)

    def depth_head(jax, torch_key):
        r.conv(f"{jax}/conv/conv", f"{torch_key}.0", bias=True)
        r.bn(f"{jax}/conv/bn", f"{torch_key}.1")
        r.conv(f"{jax}/out", f"{torch_key}.3", bias=True)

    if lss_version == "v2":
        depth_head("depth_net/depth_c3", "depth_net.depth_c3")
        depth_head("depth_net/depth_c4", "depth_net.depth_c4")
        _seq(r, "depth_net/fusion", "depth_net.fusion")
    else:
        depth_head("depth_net/depth_head", "depth_net.depth_head")
    r.conv("cam_encode/feat_proj", "cam_encode.feat_proj", bias=True)
    _seq(r, "bev_encoder/compress", "bev_encoder.compress")
    enc_j, enc_t = "bev_encoder/transformer/encoder", "bev_encoder.transformer.encoder"
    for lin in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        r.linear(f"{enc_j}/self_attn/{lin}", f"{enc_t}.self_attn.{lin}")
    r.linear(f"{enc_j}/linear1", f"{enc_t}.linear1")
    r.linear(f"{enc_j}/linear2", f"{enc_t}.linear2")
    r.layernorm(f"{enc_j}/norm1", f"{enc_t}.norm1")
    r.layernorm(f"{enc_j}/norm2", f"{enc_t}.norm2")
    r.conv("bev_encoder/seg0/conv", "bev_encoder.seg_head.0", bias=True)
    r.bn("bev_encoder/seg0/bn", "bev_encoder.seg_head.1")
    r.conv("bev_encoder/seg1/conv", "bev_encoder.seg_head.3", bias=True)
    r.bn("bev_encoder/seg1/bn", "bev_encoder.seg_head.4")
    r.conv("bev_encoder/seg_out", "bev_encoder.seg_head.6", bias=True)


def _vovnet_simple_rules(model_name: str = "vovnet57") -> _Rules:
    """VoVNetSimple at the root, as the JAX package's
    `port/torch_port.py::add_vovnet_scratch` maps it."""
    r = _Rules()
    for i, t in enumerate((0, 3, 6)):
        r.conv_bn(f"stem{i}", f"stem.{t}", f"stem.{t + 1}")
    for s, (blocks, _) in enumerate(VoVNetSimple.STAGE_CONFIGS[model_name]):
        for b in range(blocks):
            jb, tb = f"stage{s + 1}_block{b}", f"stage{s + 1}.{b}"
            for i in range(5):
                r.conv_bn(f"{jb}/conv{i}", f"{tb}.layers.{i}.0", f"{tb}.layers.{i}.1")
            r.conv_bn(f"{jb}/concat_conv", f"{tb}.concat_conv.0", f"{tb}.concat_conv.1")
            r.conv(f"{jb}/ese/fc", f"{tb}.ese.fc", bias=True)
    return r


def _flagship_rules(model_name="vovnet39", lss_version="v2", use_camera_attn=True,
                    use_cross_attn=True) -> _Rules:
    r = _Rules()
    _bev_branch_rules(r, model_name, lss_version)
    for name in ("scale1", "scale2", "fusion"):
        _seq(r, f"feature_pyramid/{name}", f"feature_pyramid.{name}")
    _aspp(r, "sceneunder/aspp", "sceneunder.0")
    if use_camera_attn:
        r.copy("camera_transformer/cam_embed/embedding", "camera_transformer.cam_embed.weight")
        r.mha("camera_transformer/self_attn", "camera_transformer.self_attn")
        r.layernorm("camera_transformer/norm1", "camera_transformer.norm1")
        r.layernorm("camera_transformer/norm2", "camera_transformer.norm2")
        r.linear("camera_transformer/ffn0", "camera_transformer.ffn.0")
        r.linear("camera_transformer/ffn1", "camera_transformer.ffn.3")
    if use_cross_attn:
        r.mha("bev_fusion/cross_attn", "bev_fusion.cross_attn")
        r.layernorm("bev_fusion/norm", "bev_fusion.norm")
    r.copy("unified_predictor/camera_weights", "unified_predictor.camera_weights")
    for jax, idx in (("enc0", 0), ("enc1", 4)):
        r.linear(f"unified_predictor/{jax}", f"unified_predictor.encoder.{idx}")
    for jax, idx in (("enc_norm0", 1), ("enc_norm1", 5)):
        r.layernorm(f"unified_predictor/{jax}", f"unified_predictor.encoder.{idx}")
    r.linear("unified_predictor/action_head", "unified_predictor.action_head")
    r.linear("unified_predictor/desc_head", "unified_predictor.desc_head")
    return r


def _get(tree: Tree, path: str) -> np.ndarray:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return np.asarray(node, dtype=np.float32)


STACK_A = ("lss", "bev_txt", "bev_txt_onlybev")


def state_dict_from_jax(params: Tree, batch_stats: Tree, family: str = "vovnet_transformer",
                        effnet_variant: str = "b4", **flagship_flags) -> Dict[str, torch.Tensor]:
    """The port's state_dict (float32 CPU tensors) from the JAX model's
    variables. `family` is `ModelConfig.family`, or "vovnet_simple" for
    `nn/vovnet.py::VoVNetSimple` alone; Stack A's take `effnet_variant`, the
    flagship its flags `model_name` (`vovnet_type`), `lss_version`,
    `use_camera_attn` and `use_cross_attn`, the pretrain model
    `model_name` and `lss_version`, VoVNetSimple `model_name`."""
    if family in STACK_A:
        if flagship_flags:
            raise TypeError(f"family {family!r} takes no flags {sorted(flagship_flags)}")
        rules = _stack_a_rules(family, effnet_variant)
    elif family == "vovnet_transformer":
        rules = _flagship_rules(**flagship_flags)
    elif family == "vovnet_pretrain":
        rules = _Rules()
        _bev_branch_rules(rules, **flagship_flags)
    elif family == "vovnet_simple":
        rules = _vovnet_simple_rules(**flagship_flags)
    else:
        raise ValueError(f"no weight mapping for family {family!r}")
    sd: Dict[str, torch.Tensor] = {}
    for jax, key, kind in rules.rules:
        if kind == "count":
            sd[key] = torch.tensor(0, dtype=torch.int64)
            continue
        if kind == "stat":
            v = _get(batch_stats, jax)
        elif kind in ("inproj_w", "inproj_b"):
            part = "kernel" if kind == "inproj_w" else "bias"
            qkv = [_get(params, f"{jax}/{n}_proj/{part}") for n in ("q", "k", "v")]
            v = np.concatenate([t.T for t in qkv] if part == "kernel" else qkv, axis=0)
        else:
            v = _get(params, jax)
            if kind == "conv":
                v = np.transpose(v, (3, 2, 0, 1))
            elif kind == "linear":
                v = v.T
        sd[key] = torch.tensor(v)
    return sd
