"""Carry the JAX package's weights into the port.

``from_jax_variables`` is the inverse of the ``fai_detr``/``resnet`` rules in
``focoos_tpu/utils/torch_convert.py`` (which imports jax, so the port cannot
use it): it maps the flat ``params/…``/``batch_stats/…`` arrays of a
``model_final.npz`` (``focoos_tpu/utils/checkpoint.py:40-50``) onto a port
``state_dict`` with the reference's torch names:

- conv kernels HWIO → OIHW, dense kernels [in, out] → [out, in];
- ``q_proj``/``k_proj``/``v_proj`` → the merged ``in_proj_weight``/``in_proj_bias``;
- norm ``scale`` → ``weight``; ``batch_stats`` mean/var → ``running_mean``/``running_var``
  (plus ``num_batches_tracked``, which the JAX tree has no counterpart for).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

Rule = Tuple[str, Callable[[re.Match], str]]


def _resnet_rules(jp: str, tp: str) -> List[Rule]:
    """ResNet module paths: conv1_k → conv1.conv1_k, res{s}_block{j} →
    res_layers.{s-2}.blocks.{j}, short_conv → short.conv."""
    return [
        (rf"{jp}(conv1_\d)", lambda m: f"{tp}conv1.{m[1]}"),
        (
            rf"{jp}res(\d)_block(\d+)/(branch2[abc]|short_conv|short)",
            lambda m: f"{tp}res_layers.{int(m[1]) - 2}.blocks.{m[2]}.{m[3].replace('short_conv', 'short.conv')}",
        ),
    ]


def _csp(m: re.Match, tp: str) -> str:
    return f"{tp}{m[1]}.{m[2]}" + (f".bottlenecks.{m[3]}" if m[3] is not None else "") + f".{m[4]}"


def _fai_detr_rules() -> List[Rule]:
    pd, pr = "pixel_decoder.", "head.predictor."
    return _resnet_rules("backbone/", f"{pd}backbone.") + [
        (r"pixel_decoder/input_proj_(\d+)_conv", lambda m: f"{pd}input_proj.{m[1]}.0"),
        (r"pixel_decoder/input_proj_(\d+)_bn", lambda m: f"{pd}input_proj.{m[1]}.1"),
        (r"pixel_decoder/encoder_(\d+)_layers_(\d+)/(\w+)", lambda m: f"{pd}encoder.{m[1]}.layers.{m[2]}.{m[3]}"),
        (r"pixel_decoder/(lateral_convs|downsample_convs)_(\d+)", lambda m: f"{pd}{m[1]}.{m[2]}"),
        (r"pixel_decoder/(fpn_blocks|pan_blocks)_(\d+)(?:/bottlenecks_(\d+))?/(conv\d)", lambda m: _csp(m, pd)),
        (r"pixel_decoder/mask_features", lambda m: f"{pd}mask_features"),
        (r"predictor/input_proj_(\d+)_conv", lambda m: f"{pr}input_proj.{m[1]}.conv"),
        (r"predictor/input_proj_(\d+)_bn", lambda m: f"{pr}input_proj.{m[1]}.norm"),
        (r"predictor/decoder_layers_(\d+)/(\w+)(?:/(\w+))?",
         lambda m: f"{pr}decoder.layers.{m[1]}.{m[2]}" + (f".{m[3]}" if m[3] else "")),
        (r"predictor/(query_pos_head|enc_bbox_classifier)/layers_(\d+)", lambda m: f"{pr}{m[1]}.layers.{m[2]}"),
        (r"predictor/enc_output_(\d)", lambda m: f"{pr}enc_output.{m[1]}"),
        (r"predictor/enc_score_classifier", lambda m: f"{pr}enc_score_classifier"),
        (r"predictor/dec_score_classifier_(\d+)", lambda m: f"{pr}dec_score_classifier.{m[1]}"),
        (r"predictor/dec_bbox_classifier_(\d+)/layers_(\d+)", lambda m: f"{pr}dec_bbox_classifier.{m[1]}.layers.{m[2]}"),
    ]


FAMILY_RULES: Dict[str, Callable[[], List[Rule]]] = {
    "fai_detr": _fai_detr_rules,
    "resnet": lambda: _resnet_rules("", ""),
}

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _module_path(path: str, rules: List[Rule]) -> str:
    # ConvNorm keeps its BatchNorm under norm/bn in JAX, under .norm in torch
    path = path.replace("/norm/bn", "/norm")
    for pat, fn in rules:
        m = re.fullmatch(pat, path)
        if m:
            return fn(m)
        m = re.match(pat + "/", path)
        if m:  # a rule names the module; its submodules keep their names
            return fn(m) + "." + path[m.end():].replace("/", ".")
    raise KeyError(f"no rule maps the JAX module path '{path}'")


def from_jax_variables(flat: Dict[str, np.ndarray], family: str) -> Dict[str, torch.Tensor]:
    """Flat ``{"params/…": array, "batch_stats/…": array}`` → port state_dict."""
    rules = FAMILY_RULES[family]()
    sd: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for key, arr in flat.items():
        collection, *parts = key.split("/")
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected collection in '{key}'")
        leaf = parts[-1]
        module = "/".join(parts[:-1])
        arr = np.asarray(arr)
        proj = re.fullmatch(r"(.*)/([qkv])_proj", module)
        if proj:  # MultiheadAttention: gather q/k/v, merge below
            qkv.setdefault(proj[1], {})[f"{proj[2]}_{leaf}"] = arr
            continue
        name = f"{_module_path(module, rules)}.{_LEAF[leaf]}"
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
        if leaf == "mean":
            sd[f"{_module_path(module, rules)}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    for base, t in qkv.items():
        prefix = _module_path(base, rules)
        sd[f"{prefix}.in_proj_weight"] = torch.from_numpy(
            np.ascontiguousarray(np.concatenate([t["q_kernel"].T, t["k_kernel"].T, t["v_kernel"].T]))
        )
        sd[f"{prefix}.in_proj_bias"] = torch.from_numpy(np.concatenate([t["q_bias"], t["k_bias"], t["v_bias"]]))
    return sd
