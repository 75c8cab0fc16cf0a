"""Pretrained-weight initialisation: load name -> array files and merge them
into the model's tensors (counterpart of ``accel_tpu/core/pretrained.py``).

The reference's ``train_end2end.py`` loads ``resnet_v1_101-0000.params`` and
``flownet-0000.params`` (``lib/utils/load_model.py:load_param``) and merges
both into the freshly initialised weights before ``fit``; the stages that
``network.FIXED_PARAMS`` names stay frozen (``core/trainer.py``'s mask).

Sources (:func:`load_named_arrays`): MXNet ``.params`` (the reference's
format, ``{prefix}-{epoch:04d}.params`` naming honoured; ``utils/mxnet_io``),
``.npz`` (``arg:``/``aux:`` or ``params/``/``stats/`` keys) and torchvision
ResNet ``.pth`` state_dicts (:func:`convert_torch_resnet`).

The merge works on a dict of the port's tensors by ``state_dict`` key. Each
pretrained name is resolved, in order, as

1. a '/'-joined flax path (``layer1_block0/conv1/kernel``) relative to
   the target submodule or from the root, or led by ``params`` or
   ``batch_stats`` from the root; the leaves map as the weight bridge maps them
   (``convert.py``: ``kernel``, HWIO, becomes ``weight``, OIHW);
2. a port key (``layer1_block0.conv1.weight``), relative to the target
   submodule or from the root, taken as it is;
3. a Caffe/MSRA MXNet ResNet name (``conv1_weight``, ``bn_conv1_gamma``,
   ``res4b22_branch2c_weight``, ``bn5a_branch1_moving_var`` ...), through
   :func:`caffe_resnet_table`. MXNet conv weights are OIHW, as the port's
   are, so they are not transposed (the JAX loader transposes them to its
   HWIO).

A name that resolves to a tensor of another shape is reported and skipped;
a name that resolves to nothing (the ImageNet ``fc1000`` of a reference
file) is reported, not fatal.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from accel_tpu_torch.models.resnet import STAGE_PLANS, embed_conv7_as_s2d

# flax leaf name -> the port's (convert.py's mapping)
_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}


def _caffe_block_names(depth: int, n_blocks: int) -> list[str]:
    """Caffe ResNet block suffixes: letters up to depth 50 (res3a..res3d);
    'a', 'b1'..'bN' for the long stages of 101/152 (res4a, res4b1..b22)."""
    if depth >= 101 and n_blocks > 3:
        return ["a"] + [f"b{i}" for i in range(1, n_blocks)]
    return [chr(ord("a") + i) for i in range(n_blocks)]


def caffe_resnet_table(depth: int) -> dict[str, str]:
    """MXNet ResNet parameter name -> the port key under the backbone
    module (``conv1.weight``, ``bn.running_mean``,
    ``layer3_block4.conv2.weight``, ``layer1_block0.ds_bn.bias`` ...)."""
    kind, plan = STAGE_PLANS[depth]
    convs = ("conv1", "conv2") if kind == "basic" else ("conv1", "conv2", "conv3")
    branches = ("branch2a", "branch2b") if kind == "basic" else (
        "branch2a", "branch2b", "branch2c")
    table = {"conv1_weight": "conv1.weight"}

    def bn(mx_base: str, key: str):
        table[f"{mx_base}_gamma"] = f"{key}.weight"
        table[f"{mx_base}_beta"] = f"{key}.bias"
        table[f"{mx_base}_moving_mean"] = f"{key}.running_mean"
        table[f"{mx_base}_moving_var"] = f"{key}.running_var"

    bn("bn_conv1", "bn")
    for si, n_blocks in enumerate(plan):
        stage = si + 2  # res2..res5
        for bi, blk in enumerate(_caffe_block_names(depth, n_blocks)):
            mod = f"layer{si + 1}_block{bi}"
            for conv, br in zip(convs, branches):
                table[f"res{stage}{blk}_{br}_weight"] = f"{mod}.{conv}.weight"
                bn(f"bn{stage}{blk}_{br}", f"{mod}.{conv.replace('conv', 'bn')}")
            table[f"res{stage}{blk}_branch1_weight"] = f"{mod}.downsample.weight"
            bn(f"bn{stage}{blk}_branch1", f"{mod}.ds_bn")
    return table


def _flax_candidates(name: str, prefix: str) -> list[tuple[str, bool]]:
    """A '/'-joined flax path -> [(port key, is a conv kernel)]: one led by
    its collection (``params``/``batch_stats``) from the root, any other
    relative to ``prefix`` first, then from the root; [] where its leaf
    is unknown."""
    parts = name.split("/")
    rooted = parts[0] in ("params", "batch_stats")
    if rooted:
        parts = parts[1:]
    if len(parts) < 2 or parts[-1] not in _LEAVES:
        return []
    key = ".".join(parts[:-1] + [_LEAVES[parts[-1]]])
    kernel = parts[-1] == "kernel"
    return [(key, kernel)] if rooted or not prefix else [(prefix + key, kernel), (key, kernel)]


def merge_pretrained(variables: dict[str, torch.Tensor], arg_params: dict, aux_params: dict,
                     submodule: tuple[str, ...] = (), depth: int | None = None, logger=None):
    """Merge name -> array dicts into ``variables`` (tensors by the port's
    ``state_dict`` keys). ``submodule`` roots relative names and the Caffe
    table (e.g. ``('ref_net', 'backbone')``); ``depth`` enables the table.
    Returns (a new dict, {'matched': n, 'skipped_shape': [(name, shape,
    target shape)], 'unmatched': [name]})."""
    log = logger.info if logger else (lambda *_: None)
    prefix = "".join(f"{m}." for m in submodule)
    table = caffe_resnet_table(depth) if depth else {}
    out = dict(variables)
    matched, skipped_shape, unmatched = [], [], []

    def try_set(key: str, arr, name: str, kernel: bool) -> bool:
        target = out.get(key)
        if target is None:
            return False
        a = np.asarray(arr)
        if kernel and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # flax HWIO -> OIHW
        if tuple(a.shape) != tuple(target.shape):
            skipped_shape.append((name, tuple(a.shape), tuple(target.shape)))
            return True  # the name resolved, to an unusable tensor: no other try
        out[key] = torch.as_tensor(np.ascontiguousarray(a), dtype=target.dtype)
        matched.append(name)
        return True

    for name, arr in [*arg_params.items(), *aux_params.items()]:
        if "/" in name:
            cands = _flax_candidates(name, prefix)
        elif "." in name:
            cands = [(prefix + name, False), (name, False)] if prefix else [(name, False)]
        elif name in table:
            cands = [(prefix + table[name], False)]
        else:
            cands = []
        if not any(try_set(key, arr, name, kernel) for key, kernel in cands):
            unmatched.append(name)

    log(f"pretrained merge into /{'/'.join(submodule) or '(root)'}: {len(matched)} tensors "
        f"matched, {len(skipped_shape)} shape-skipped, {len(unmatched)} unmatched")
    if skipped_shape:
        log(f"  shape-skipped: {[s[0] for s in skipped_shape][:8]} ...")
    return out, {"matched": len(matched), "skipped_shape": skipped_shape,
                 "unmatched": unmatched}


def convert_torch_resnet(state_dict: dict, depth: int, stem: str = "conv7") -> tuple[dict, dict]:
    """A torchvision ResNet ``state_dict`` -> (parameters, running
    statistics) as numpy arrays by the port's keys under the backbone
    (the port's copy of ``tools/convert_params.py::convert_torch_resnet``;
    both layouts are OIHW, so nothing is transposed). ``stem='s2d'``
    embeds the 7x7/2 conv1 into ``conv1_s2d`` (``embed_conv7_as_s2d``)."""
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in state_dict.items()}
    params, stats = {}, {}

    def norm(src: str, dst: str):
        params[f"{dst}.weight"], params[f"{dst}.bias"] = sd[f"{src}.weight"], sd[f"{src}.bias"]
        stats[f"{dst}.running_mean"] = sd[f"{src}.running_mean"]
        stats[f"{dst}.running_var"] = sd[f"{src}.running_var"]

    if stem == "s2d":
        params["conv1_s2d.weight"] = embed_conv7_as_s2d(
            torch.from_numpy(sd["conv1.weight"])).numpy()
    else:
        params["conv1.weight"] = sd["conv1.weight"]
    norm("bn1", "bn")
    kind, plan = STAGE_PLANS[depth]
    n_convs = 2 if kind == "basic" else 3
    for si, n_blocks in enumerate(plan):
        for bi in range(n_blocks):
            t, f = f"layer{si + 1}.{bi}", f"layer{si + 1}_block{bi}"
            for ci in range(1, n_convs + 1):
                params[f"{f}.conv{ci}.weight"] = sd[f"{t}.conv{ci}.weight"]
                norm(f"{t}.bn{ci}", f"{f}.bn{ci}")
            if f"{t}.downsample.0.weight" in sd:
                params[f"{f}.downsample.weight"] = sd[f"{t}.downsample.0.weight"]
                norm(f"{t}.downsample.1", f"{f}.ds_bn")
    return params, stats


def load_named_arrays(path: str, epoch: int = 0, depth: int | None = None):
    """A pretrained file -> (arg_params, aux_params), name -> numpy array.
    A missing ``path`` is tried as the prefix of ``{path}-{epoch:04d}.params``."""
    if not os.path.exists(path):
        cand = f"{path}-{epoch:04d}.params"
        if not os.path.exists(cand):
            raise FileNotFoundError(f"pretrained file not found: {path} (or {cand})")
        path = cand
    if path.endswith(".params"):
        from accel_tpu_torch.utils.mxnet_io import load_mxnet_params

        return load_mxnet_params(path)
    if path.endswith(".npz"):
        data = np.load(path)
        arg, aux = {}, {}
        for k in data.files:
            for lead, into in (("arg:", arg), ("aux:", aux), ("params/", arg), ("stats/", aux)):
                if k.startswith(lead):
                    into[k[len(lead):]] = data[k]
                    break
            else:
                arg[k] = data[k]
        return arg, aux
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return convert_torch_resnet(sd, depth or 101)
    raise ValueError(f"unsupported pretrained format: {path}")


def apply_pretrained_cfg(cfg, variables: dict[str, torch.Tensor], logger=None):
    """``network.pretrained`` (into the reference branch's backbone),
    ``pretrained_update`` (the update branch's) and ``pretrained_flow``
    (FlowNet), with ``pretrained_epoch``: the reference train script's
    load_param + merge. ``variables``: the port's tensors by ``state_dict``
    key. Returns (the merged dict, {'ref'|'update'|'flow': report})."""
    net = cfg.network
    epoch = int(net.get("pretrained_epoch", 0) or 0)
    if (str(net.get("pretrained_flow", "") or "")
            and str(net.get("scale_field_norm", "none")) != "none"):
        msg = ("network.pretrained_flow is set but scale_field_norm="
               f"{net.get('scale_field_norm')!r}: reference FlowNet weights were trained with "
               "the raw (gain-covariant) scale field — set scale_field_norm: none for weight "
               "parity, or retrain the fusion/head under the normalized field")
        (logger.warning if logger else print)(msg)
    jobs = [(str(net.get("pretrained", "") or ""), ("ref_net", "backbone"),
             int(net.ref_depth), "ref"),
            (str(net.get("pretrained_update", "") or ""), ("update_net", "backbone"),
             int(net.get("update_depth", 0) or 0), "update"),
            (str(net.get("pretrained_flow", "") or ""), ("flownet",), None, "flow")]
    reports = {}
    for path, submodule, depth, tag in jobs:
        if not path:
            continue
        arg, aux = load_named_arrays(path, epoch, depth)
        variables, reports[tag] = merge_pretrained(variables, arg, aux, submodule=submodule,
                                                   depth=depth, logger=logger)
    return variables, reports
