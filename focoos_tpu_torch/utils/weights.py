"""Carry weights between the JAX package and the port (``to_jax_variables``
is the way back).

``from_jax_variables`` is the inverse of the ``fai_detr``/``fai_mf``/``bisenetformer``/
``fai_cls``/``resnet``/``stdc``/``rtmo``/``csp_darknet`` rules in ``focoos_tpu/utils/torch_convert.py`` (which imports
jax, so the port cannot use it): it maps the flat ``params/…``/``batch_stats/…`` arrays of a
``model_final.npz`` (``focoos_tpu/utils/checkpoint.py:40-50``) onto a port
``state_dict`` with the reference's torch names:

- conv kernels HWIO → OIHW, dense kernels [in, out] → [out, in];
- ``q_proj``/``k_proj``/``v_proj`` → the merged ``in_proj_weight``/``in_proj_bias``;
- norm ``scale`` → ``weight``; ``batch_stats`` mean/var → ``running_mean``/``running_var``
  (plus ``num_batches_tracked``, which the JAX tree has no counterpart for);
- bare parameters (rtmo's DCC/GAU ``pos_enc``, ``gamma``, ``beta``, ``ln_g``,
  ``res_scale``, ``sigma_scale``; the masked decoders' query embeddings) → the
  reference's names, as they are;
- an int8 store's ``<kernel>@q`` / ``<kernel>@scale`` pairs (``infer/quantizer.py``)
  → the dequantized weight, the int8 values times their scale in fp32 (JAX's
  ``[1, 1, 1, O]`` / ``[1, O]`` scale as ``[O]`` on the output axis), as
  JAX's ``Int8XLARuntime`` dequantizes.

``jax_module_paths`` names the JAX module path of port modules: the keys of
a ``calibration.npz``, which both packages read.
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


_STDC_PARTS = {"avd_conv": "avd_layer.0", "avd_bn": "avd_layer.1", "skip_dw": "skip.0", "skip_dw_bn": "skip.1",
               "skip_pw": "skip.2", "skip_pw_bn": "skip.3"}


def _stdc_rules(jp: str, tp: str) -> List[Rule]:
    """STDC module paths: features_{i} → features.{i} (a ConvX keeps conv/bn),
    conv_list_{j} → conv_list.{j}, avd_conv/avd_bn → avd_layer.{0,1},
    skip_{dw,pw}[_bn] → skip.{0..3}."""
    return [
        (rf"{jp}features_(\d+)/conv_list_(\d+)", lambda m: f"{tp}features.{m[1]}.conv_list.{m[2]}"),
        (rf"{jp}features_(\d+)/({'|'.join(_STDC_PARTS)})", lambda m: f"{tp}features.{m[1]}.{_STDC_PARTS[m[2]]}"),
        (rf"{jp}features_(\d+)", lambda m: f"{tp}features.{m[1]}"),
    ]


def _csp(m: re.Match, tp: str) -> str:
    return f"{tp}{m[1]}.{m[2]}" + (f".bottlenecks.{m[3]}" if m[3] is not None else "") + f".{m[4]}"


def _fai_detr_rules() -> List[Rule]:
    pd, pr = "pixel_decoder.", "head.predictor."
    # every backbone's rules, as torch_convert.backbone_rules: their module paths are disjoint
    return _resnet_rules("backbone/", f"{pd}backbone.") + _stdc_rules("backbone/", f"{pd}backbone.") + [
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


def _masked_decoder_rules() -> List[Rule]:
    """torch_convert.masked_decoder_rules, inverted (fai_mf and bisenetformer)."""
    pr, fh = "head.predictor.", "predictor/forward_prediction_heads"
    return [
        (r"predictor/input_proj_(\d+)", lambda m: f"{pr}input_proj.{m[1]}"),
        (r"predictor/(transformer_\w+?_layers)_(\d+)", lambda m: f"{pr}{m[1]}.{m[2]}"),
        (rf"{fh}/mask_classifier/layers_(\d+)", lambda m: f"{pr}forward_prediction_heads.mask_classifier.layers.{m[1]}"),
        (fh, lambda m: f"{pr}forward_prediction_heads"),
    ]


def _fai_mf_rules() -> List[Rule]:
    """torch_convert.fai_mf_rules, inverted."""
    pd = "pixel_decoder."
    return _resnet_rules("backbone/", f"{pd}backbone.") + _stdc_rules("backbone/", f"{pd}backbone.") + [
        (r"pixel_decoder/input_proj", lambda m: f"{pd}input_proj"),
        (r"pixel_decoder/transformer_layers_(\d+)", lambda m: f"{pd}transformer.encoder.layers.{m[1]}"),
        (r"pixel_decoder/transformer_norm", lambda m: f"{pd}transformer.encoder.norm"),
        (r"pixel_decoder/(adapter|layer)_(\d)_conv", lambda m: f"{pd}{m[1]}_{m[2]}"),
        (r"pixel_decoder/(adapter|layer)_(\d)_norm", lambda m: f"{pd}{m[1]}_{m[2]}.norm"),
        (r"pixel_decoder/mask_features", lambda m: f"{pd}mask_features"),
    ] + _masked_decoder_rules()


def _bisenetformer_rules() -> List[Rule]:
    """torch_convert.bisenetformer_rules, inverted. Its ``cp.arm8`` and
    ``cp.conv_head8`` rules match no module of the model (BiseNet has no
    stride-8 ARM or head): the port leaves them out."""
    pd = "pixel_decoder."
    return _stdc_rules("backbone/", f"{pd}backbone.") + [
        (r"pixel_decoder/cp_(arm\d+|conv_avg|conv_head\d+)", lambda m: f"{pd}cp.{m[1]}"),
        (r"pixel_decoder/(ffm|conv_out)", lambda m: f"{pd}{m[1]}"),
    ] + _masked_decoder_rules()


def _csp_darknet_rules(jp: str, tp: str) -> List[Rule]:
    """CSPDarknet module paths: stage{i}_conv → stage{i}.0, stage4_spp →
    stage4.1, stage{i}_csp → stage{i}.1 (stage4.2 after the SPP),
    blocks_{j} → blocks.{j}; the Focus stem keeps stem/conv/{conv,bn}."""

    def csp(m: re.Match) -> str:
        return f"{tp}stage{m[1]}.{2 if m[1] == '4' else 1}"

    return [
        (rf"{jp}stage(\d)_csp/blocks_(\d+)", lambda m: f"{csp(m)}.blocks.{m[2]}"),
        (rf"{jp}stage(\d)_csp", csp),
        (rf"{jp}stage(\d)_conv", lambda m: f"{tp}stage{m[1]}.0"),
        (rf"{jp}stage4_spp", lambda m: f"{tp}stage4.1"),
        (rf"{jp}stem", lambda m: f"{tp}stem"),
    ]


def _rtmo_rules() -> List[Rule]:
    nk, hm, dcc = "neck.", "head.head_module.", "head.dcc."
    enc = r"neck/encoder_0_layers_(\d+)"
    return _csp_darknet_rules("backbone/", "backbone.") + [
        (r"neck/input_proj_(\d+)", lambda m: f"{nk}input_proj.{m[1]}"),
        (rf"{enc}/self_attn", lambda m: f"{nk}encoder.0.layers.{m[1]}.self_attn.attn"),
        (rf"{enc}/ffn_linear1", lambda m: f"{nk}encoder.0.layers.{m[1]}.ffn.layers.0.0"),
        (rf"{enc}/ffn_linear2", lambda m: f"{nk}encoder.0.layers.{m[1]}.ffn.layers.1"),
        (rf"{enc}/norm(\d)", lambda m: f"{nk}encoder.0.layers.{m[1]}.norms.{int(m[2]) - 1}"),
        (r"neck/(lateral_convs|downsample_convs)_(\d+)", lambda m: f"{nk}{m[1]}.{m[2]}"),
        (r"neck/(fpn_blocks|pan_blocks)_(\d+)/bottlenecks_(\d+)", lambda m: f"{nk}{m[1]}.{m[2]}.bottlenecks.{m[3]}"),
        (r"neck/(fpn_blocks|pan_blocks)_(\d+)", lambda m: f"{nk}{m[1]}.{m[2]}"),
        (r"neck/projector_(\d+)_(conv|bn)", lambda m: f"{nk}projector.convs.{m[1]}.{m[2]}"),
        (r"head_module/(conv_cls|conv_pose)_(\d+)_(\d+)_(conv|bn)", lambda m: f"{hm}{m[1]}.{m[2]}.{m[3]}.{m[4]}"),
        (r"head_module/(out_cls|out_bbox|out_kpt_reg|out_kpt_vis|out_pose)_(\d+)", lambda m: f"{hm}{m[1]}.{m[2]}"),
        (r"dcc/(x_fc|y_fc)", lambda m: f"{dcc}{m[1]}"),
        (r"dcc/pose_to_kpts_fc", lambda m: f"{dcc}pose_to_kpts.0"),
        (r"dcc/pose_to_kpts_bn", lambda m: f"{dcc}pose_to_kpts.1"),
        (r"dcc/sigma_fc", lambda m: f"{dcc}sigma_fc.0"),
        (r"dcc/gau/(uv|o)", lambda m: f"{dcc}gau.{m[1]}"),
    ]


def _fai_cls_rules(two_layers: bool = False) -> List[Rule]:
    """torch_convert.fai_cls_rules, inverted: the head's ``fc1`` is the
    reference's ``classifier.2`` in a one-layer head, ``classifier.1`` in a
    two-layer one, whose ``fc2`` is ``classifier.4``."""
    head = {"fc1": "1" if two_layers else "2", "fc2": "4"}
    return _resnet_rules("backbone/", "backbone.") + _stdc_rules("backbone/", "backbone.") + [
        (r"cls_head/(fc[12])", lambda m: f"cls_head.classifier.{head[m[1]]}"),
    ]


FAMILY_RULES: Dict[str, Callable[[], List[Rule]]] = {
    "fai_detr": _fai_detr_rules,
    "fai_mf": _fai_mf_rules,
    "bisenetformer": _bisenetformer_rules,
    "resnet": lambda: _resnet_rules("", ""),
    "stdc": lambda: _stdc_rules("", ""),
    "rtmo": _rtmo_rules,
    "csp_darknet": lambda: _csp_darknet_rules("", ""),
}

_QUERY_EMBEDDINGS = {
    "predictor/query_feat": "head.predictor.query_feat.weight",
    "predictor/query_embed": "head.predictor.query_embed.weight",
}
# bare parameters (not a kernel, bias or norm scale): full JAX path → torch name, carried as they are
FAMILY_PARAMS: Dict[str, Dict[str, str]] = {
    "rtmo": {
        "dcc/pos_enc": "head.dcc.pos_enc",
        "dcc/sigma_scale": "head.dcc.sigma_fc.2.scale",
        "dcc/gau/gamma": "head.dcc.gau.gamma",
        "dcc/gau/beta": "head.dcc.gau.beta",
        "dcc/gau/ln_g": "head.dcc.gau.ln.g",
        "dcc/gau/res_scale": "head.dcc.gau.res_scale.scale",
    },
    "fai_mf": _QUERY_EMBEDDINGS,
    "bisenetformer": _QUERY_EMBEDDINGS,
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


def _family_rules(family: str, keys) -> List[Rule]:
    """The family's JAX → torch rules. fai_cls's depend on its head's depth:
    two layers where ``keys`` (JAX paths or torch names) hold the second."""
    if family == "fai_cls":
        return _fai_cls_rules(any(re.search(r"cls_head(/fc2/|\.classifier\.4\.)", k) for k in keys))
    return FAMILY_RULES[family]()


def from_jax_variables(flat: Dict[str, np.ndarray], family: str) -> Dict[str, torch.Tensor]:
    """Flat ``{"params/…": array, "batch_stats/…": array}`` → port state_dict."""
    rules = _family_rules(family, flat)
    params = FAMILY_PARAMS.get(family, {})
    sd: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for key, arr in flat.items():
        if key.endswith("@scale"):
            continue  # read with its "@q"
        collection, *parts = key.split("/")
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected collection in '{key}'")
        leaf = parts[-1]
        module = "/".join(parts[:-1])
        arr = np.asarray(arr)
        if leaf == "kernel@q":  # per output channel: the scale's [O] along the kernel's last axis
            leaf, scale = "kernel", np.asarray(flat[key[:-2] + "@scale"]).reshape(-1)
            arr = arr.astype(np.float32) * scale
        if module + "/" + leaf in params:
            sd[params[module + "/" + leaf]] = torch.tensor(arr)  # a copy; keeps 0-d scalars 0-d
            continue
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


def _inverse_backbone_rules(tp: str = r"pixel_decoder\.backbone\.") -> List[Rule]:
    """ResNet and STDC under ``tp``: ``pixel_decoder.backbone``, as fai_mf and
    bisenetformer hold them, or ``backbone``, as fai_cls does."""
    return [
        (rf"{tp}conv1\.(conv1_\d)", lambda m: f"backbone/{m[1]}"),
        (rf"{tp}res_layers\.(\d+)\.blocks\.(\d+)", lambda m: f"backbone/res{int(m[1]) + 2}_block{m[2]}"),
        (rf"{tp}features\.(\d+)\.conv_list\.(\d+)", lambda m: f"backbone/features_{m[1]}/conv_list_{m[2]}"),
        *((rf"{tp}features\.(\d+)\.{re.escape(t)}", lambda m, j=j: f"backbone/features_{m[1]}/{j}")
          for j, t in _STDC_PARTS.items()),
        (rf"{tp}features\.(\d+)", lambda m: f"backbone/features_{m[1]}"),
    ]


_INVERSE_MASKED_DECODER: List[Rule] = [
    (r"head\.predictor\.(\w+)\.(\d+)", lambda m: f"predictor/{m[1]}_{m[2]}"),
    (r"head\.predictor\.forward_prediction_heads", lambda m: "predictor/forward_prediction_heads"),
]

# torch module path → JAX module path, the inverse of FAMILY_RULES: a rule
# names a module; below it, "name.<i>" becomes "name_<i>" and "." becomes "/"
# (and a ResNet-D block's pooled shortcut "short.conv.*" is JAX's "short_conv/*")
INVERSE_RULES: Dict[str, Callable[[], List[Rule]]] = {
    "fai_detr": lambda: [
        (r"pixel_decoder\.backbone\.conv1\.(conv1_\d)", lambda m: f"backbone/{m[1]}"),
        (r"pixel_decoder\.backbone\.res_layers\.(\d+)\.blocks\.(\d+)",
         lambda m: f"backbone/res{int(m[1]) + 2}_block{m[2]}"),
        (r"pixel_decoder\.backbone\.features\.(\d+)\.conv_list\.(\d+)",
         lambda m: f"backbone/features_{m[1]}/conv_list_{m[2]}"),
        *((rf"pixel_decoder\.backbone\.features\.(\d+)\.{re.escape(t)}", lambda m, j=j: f"backbone/features_{m[1]}/{j}")
          for j, t in _STDC_PARTS.items()),
        (r"pixel_decoder\.backbone\.features\.(\d+)", lambda m: f"backbone/features_{m[1]}"),
        (r"pixel_decoder\.input_proj\.(\d+)\.0", lambda m: f"pixel_decoder/input_proj_{m[1]}_conv"),
        (r"pixel_decoder\.input_proj\.(\d+)\.1", lambda m: f"pixel_decoder/input_proj_{m[1]}_bn"),
        (r"pixel_decoder\.encoder\.(\d+)\.layers\.(\d+)", lambda m: f"pixel_decoder/encoder_{m[1]}_layers_{m[2]}"),
        (r"pixel_decoder\.(\w+)\.(\d+)", lambda m: f"pixel_decoder/{m[1]}_{m[2]}"),
        (r"pixel_decoder\.mask_features", lambda m: "pixel_decoder/mask_features"),
        (r"head\.predictor\.input_proj\.(\d+)\.conv", lambda m: f"predictor/input_proj_{m[1]}_conv"),
        (r"head\.predictor\.input_proj\.(\d+)\.norm", lambda m: f"predictor/input_proj_{m[1]}_bn"),
        (r"head\.predictor\.decoder\.layers\.(\d+)", lambda m: f"predictor/decoder_layers_{m[1]}"),
        (r"head\.predictor\.(\w+)\.(\d+)", lambda m: f"predictor/{m[1]}_{m[2]}"),
        (r"head\.predictor\.(\w+)", lambda m: f"predictor/{m[1]}"),
    ],
    "fai_mf": lambda: _inverse_backbone_rules() + [
        (r"pixel_decoder\.transformer\.encoder\.layers\.(\d+)", lambda m: f"pixel_decoder/transformer_layers_{m[1]}"),
        (r"pixel_decoder\.transformer\.encoder\.norm", lambda m: "pixel_decoder/transformer_norm"),
        (r"pixel_decoder\.(adapter|layer)_(\d)\.norm", lambda m: f"pixel_decoder/{m[1]}_{m[2]}_norm"),
        (r"pixel_decoder\.(adapter|layer)_(\d)", lambda m: f"pixel_decoder/{m[1]}_{m[2]}_conv"),
        (r"pixel_decoder\.(input_proj|mask_features)", lambda m: f"pixel_decoder/{m[1]}"),
    ] + _INVERSE_MASKED_DECODER,
    "bisenetformer": lambda: _inverse_backbone_rules() + [
        (r"pixel_decoder\.cp\.(\w+)", lambda m: f"pixel_decoder/cp_{m[1]}"),
        (r"pixel_decoder\.(ffm|conv_out)", lambda m: f"pixel_decoder/{m[1]}"),
    ] + _INVERSE_MASKED_DECODER,
    "fai_cls": lambda: _inverse_backbone_rules(r"backbone\.") + [
        (r"cls_head\.classifier\.([124])", lambda m: "cls_head/fc2" if m[1] == "4" else "cls_head/fc1"),
    ],
    "rtmo": lambda: [
        (r"backbone\.stage(\d)\.0", lambda m: f"backbone/stage{m[1]}_conv"),
        (r"backbone\.stage4\.1", lambda m: "backbone/stage4_spp"),
        (r"backbone\.stage(\d)\.[12]", lambda m: f"backbone/stage{m[1]}_csp"),
        (r"backbone\.stem", lambda m: "backbone/stem"),
        (r"neck\.encoder\.0\.layers\.(\d+)\.self_attn\.attn", lambda m: f"neck/encoder_0_layers_{m[1]}/self_attn"),
        (r"neck\.encoder\.0\.layers\.(\d+)\.ffn\.layers\.0\.0", lambda m: f"neck/encoder_0_layers_{m[1]}/ffn_linear1"),
        (r"neck\.encoder\.0\.layers\.(\d+)\.ffn\.layers\.1", lambda m: f"neck/encoder_0_layers_{m[1]}/ffn_linear2"),
        (r"neck\.encoder\.0\.layers\.(\d+)\.norms\.(\d)",
         lambda m: f"neck/encoder_0_layers_{m[1]}/norm{int(m[2]) + 1}"),
        (r"neck\.projector\.convs\.(\d+)\.(conv|bn)", lambda m: f"neck/projector_{m[1]}_{m[2]}"),
        (r"neck\.(\w+)\.(\d+)", lambda m: f"neck/{m[1]}_{m[2]}"),
        (r"head\.head_module\.(conv_cls|conv_pose)\.(\d+)\.(\d+)\.(conv|bn)",
         lambda m: f"head_module/{m[1]}_{m[2]}_{m[3]}_{m[4]}"),
        (r"head\.head_module\.(\w+)\.(\d+)", lambda m: f"head_module/{m[1]}_{m[2]}"),
        (r"head\.dcc\.pose_to_kpts\.([01])", lambda m: f"dcc/pose_to_kpts_{'fc' if m[1] == '0' else 'bn'}"),
        (r"head\.dcc\.sigma_fc\.0", lambda m: "dcc/sigma_fc"),
        (r"head\.dcc\.(\w+)", lambda m: f"dcc/{m[1]}"),
    ],
}


# modules named "norm" that are LayerNorms, not a ConvNorm's BatchNorm
_MASKED_DECODER_LAYER_NORMS = re.compile(r"head\.predictor\.transformer_\w+_layers\.\d+\.norm")
_LAYER_NORMS = {"fai_mf": _MASKED_DECODER_LAYER_NORMS, "bisenetformer": _MASKED_DECODER_LAYER_NORMS}


def _jax_module_path(name: str, rules: List[Rule], forward: List[Rule], batch_norm: bool) -> str:
    for pat, fn in rules:
        m = re.fullmatch(pat, name) or re.match(pat + r"\.", name)
        if m:
            rest = re.sub(r"^short\.conv\.", "short_conv.", name[m.end():].lstrip("."))
            path = fn(m) + ("/" + re.sub(r"\.(\d+)", r"_\1", rest).replace(".", "/") if rest else "")
            break
    else:
        raise KeyError(f"no inverse rule maps the torch module '{name}'")
    if batch_norm and path.endswith("/norm"):
        path += "/bn"  # a ConvNorm's norm (a BatchNorm in the port) sits under norm/bn in JAX
    # each inverse must land where the forward rules map back from
    back = _module_path(path, forward)
    if back != name:
        raise KeyError(f"torch module '{name}' → JAX '{path}' → torch '{back}'")
    return path


def jax_module_paths(names, family: str) -> Dict[str, str]:
    """{port module name: its JAX module path} for modules that hold no
    BatchNorm statistics of their own (a ConvNorm's conv, a dense layer)."""
    if family not in INVERSE_RULES:
        raise NotImplementedError(f"jax_module_paths covers {sorted(INVERSE_RULES)}, not {family}")
    names = list(names)
    rules, forward = INVERSE_RULES[family](), _family_rules(family, names)
    return {n: _jax_module_path(n, rules, forward, False) for n in names}


def to_jax_variables(state: Dict[str, np.ndarray], family: str) -> Dict[str, np.ndarray]:
    """Port state_dict (numpy) → flat ``{"params/…", "batch_stats/…"}`` of
    the JAX package's ``model_final.npz``; the inverse of
    ``from_jax_variables``. A 1-D ``weight`` is a norm scale; the merged
    ``in_proj_*`` split into q/k/v; ``num_batches_tracked`` has no JAX
    counterpart and is dropped; a bare parameter goes back to its JAX name."""
    if family not in INVERSE_RULES:
        raise NotImplementedError(f"to_jax_variables covers {sorted(INVERSE_RULES)}, not {family}")
    rules = INVERSE_RULES[family]()
    forward = _family_rules(family, state)
    bare = {t: j for j, t in FAMILY_PARAMS.get(family, {}).items()}
    layer_norm = _LAYER_NORMS.get(family)
    flat: Dict[str, np.ndarray] = {}
    for key, arr in state.items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        arr = np.asarray(arr)
        if key in bare:
            flat[f"params/{bare[key]}"] = arr
            continue
        path = _jax_module_path(module, rules, forward, not (layer_norm and layer_norm.fullmatch(module)))
        if leaf in ("in_proj_weight", "in_proj_bias"):
            for name, part in zip("qkv", np.split(arr, 3)):
                flat[f"params/{path}/{name}_proj/" + ("kernel" if leaf == "in_proj_weight" else "bias")] = (
                    np.ascontiguousarray(part.T) if part.ndim == 2 else part)
        elif leaf in ("running_mean", "running_var"):
            flat[f"batch_stats/{path}/{leaf.removeprefix('running_')}"] = arr
        elif leaf == "weight" and arr.ndim == 1:
            flat[f"params/{path}/scale"] = arr
        elif leaf == "weight":
            flat[f"params/{path}/kernel"] = np.ascontiguousarray(arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T)
        else:
            flat[f"params/{path}/{leaf}"] = arr
    return flat
