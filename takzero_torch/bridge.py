"""Carry a JAX agent bundle over into the port.

``from_jax_bundle(bundle_np, cfg, device)`` takes the bundle of
``takzero_tpu.models.agent.new_agent`` (or a learner's) as numpy arrays,
``jax.tree.map(np.asarray, bundle)``, and returns the port's bundle:

* convolution kernels go from HWIO to OIHW;
* dense kernels go from ``[in, 1]`` to ``Linear``'s ``[1, in]``;
* BatchNorm scale, bias, mean and var are copied as they are;
* the SimHash seen-set (uint32 words, kept as int32 bit patterns) and the
  SimHash matrix are taken from the bundle: torch cannot redraw JAX's PRNG,
  and the hash-log contract needs the same matrix.

This module needs neither JAX nor flax: the bundle is plain nested dicts of
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.agent import _check_novelty
from .models.network import NetConfig, TakNet, fold_inference_params


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(conv: torch.nn.Conv2d, p: dict) -> None:
    conv.weight.copy_(_t(np.transpose(p["kernel"], (3, 2, 0, 1))))
    if conv.bias is not None:
        conv.bias.copy_(_t(p["bias"]))


def _convbn(mod, p: dict, s: dict) -> None:
    _conv(mod.conv, p["Conv_0"])
    bn = mod.bn
    bn.weight.copy_(_t(p["BatchNorm_0"]["scale"]))
    bn.bias.copy_(_t(p["BatchNorm_0"]["bias"]))
    bn.running_mean.copy_(_t(s["BatchNorm_0"]["mean"]))
    bn.running_var.copy_(_t(s["BatchNorm_0"]["var"]))


def _head(mod, p: dict) -> None:
    _conv(mod.conv, p["Conv_0"])
    mod.dense.weight.copy_(_t(p["Dense_0"]["kernel"]).t())
    mod.dense.bias.copy_(_t(p["Dense_0"]["bias"]))


@torch.no_grad()
def from_jax_bundle(bundle_np: dict, cfg: NetConfig, device=None) -> dict:
    """The port's agent bundle holding the JAX bundle's weights and hashes."""
    _check_novelty(cfg)
    dev = resolve_device(device)
    params, stats = bundle_np["params"], bundle_np["batch_stats"]
    net = TakNet(cfg)
    core_p, core_s = params["core"], stats["core"]
    _convbn(net.core.stem, core_p["ConvBN_0"], core_s["ConvBN_0"])
    for i, blk in enumerate(net.core.blocks):
        bp, bs = core_p[f"ResBlock_{i}"], core_s[f"ResBlock_{i}"]
        _convbn(blk.a, bp["ConvBN_0"], bs["ConvBN_0"])
        _convbn(blk.b, bp["ConvBN_1"], bs["ConvBN_1"])
    _conv(net.policy, params["Conv_0"])
    _head(net.value, params["value"])
    _head(net.ube, params["ube"])
    net = net.to(dev).eval()
    bundle = {"net": net, "folded": fold_inference_params(cfg, net)}
    if cfg.novelty == "simhash":
        words = np.ascontiguousarray(np.asarray(bundle_np["hash_bits"], np.uint32))
        bundle["hash_bits"] = torch.from_numpy(words.view(np.int32).copy()).to(dev)
        bundle["hash_matrix"] = _t(bundle_np["hash_matrix"]).to(dev)
    return bundle
