"""Carry a JAX agent bundle over into the port.

``from_jax_bundle(bundle_np, cfg, device)`` takes the bundle of
``takzero_tpu.models.agent.new_agent`` (or a learner's) as numpy arrays,
``jax.tree.map(np.asarray, bundle)``, and returns the port's bundle:

* convolution kernels go from HWIO to OIHW;
* dense kernels go from ``[in, 1]`` to ``Linear``'s ``[1, in]``;
* BatchNorm scale, bias, mean and var are copied as they are;
* the hash seen-set (uint32 words, kept as int32 bit patterns), the SimHash
  matrix, the LCG scale, the RND predictor and target (weights, BatchNorm
  statistics, LayerNorm) with their bounds ``rnd_min``/``rnd_max``, and the
  ensemble heads are taken from the bundle: torch cannot redraw JAX's
  PRNG, and the hash-log contract needs the same hash constants.

The result evaluates and trains: a JAX ``train_step`` and the port's
``train_step`` (``takzero_torch/train/learner.py``) from the same bundle
and batch compute the same step.  Optimizer state is not carried; it
starts fresh on both sides, as in the JAX learner, whose checkpoints hold
no optax state.

This module needs neither JAX nor flax: the bundle is plain nested dicts of
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.network import EnsembleHeads, NetConfig, RndPair, TakNet, fold_inference_params


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


def _dense(dense: torch.nn.Linear, p: dict) -> None:
    dense.weight.copy_(_t(p["kernel"]).t())
    dense.bias.copy_(_t(p["bias"]))


def _head(mod, p: dict) -> None:
    _conv(mod.conv, p["Conv_0"])
    _dense(mod.dense, p["Dense_0"])


def _rnd_tower(tower, p: dict, s: dict) -> None:
    """An ``RndTower`` (LayerNorm_0, ConvBN_0, ResBlock_i, ConvBN_1) or an
    ``RndMlp`` (Dense_0..2)."""
    if "LayerNorm_0" not in p:
        for i, dense in enumerate(tower.layers):
            _dense(dense, p[f"Dense_{i}"])
        return
    tower.norm.weight.copy_(_t(p["LayerNorm_0"]["scale"]))
    tower.norm.bias.copy_(_t(p["LayerNorm_0"]["bias"]))
    _convbn(tower.stem, p["ConvBN_0"], s["ConvBN_0"])
    for i, blk in enumerate(tower.blocks):
        bp, bs = p[f"ResBlock_{i}"], s[f"ResBlock_{i}"]
        _convbn(blk.a, bp["ConvBN_0"], bs["ConvBN_0"])
        _convbn(blk.b, bp["ConvBN_1"], bs["ConvBN_1"])
    _convbn(tower.head, p["ConvBN_1"], s["ConvBN_1"])


@torch.no_grad()
def from_jax_bundle(bundle_np: dict, cfg: NetConfig, device=None) -> dict:
    """The port's agent bundle holding the JAX bundle's weights and novelty state."""
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
    if cfg.novelty in ("simhash", "lcghash"):
        words = np.ascontiguousarray(np.asarray(bundle_np["hash_bits"], np.uint32))
        bundle["hash_bits"] = torch.from_numpy(words.view(np.int32).copy()).to(dev)
        key = "hash_matrix" if cfg.novelty == "simhash" else "hash_scale"
        bundle[key] = _t(bundle_np[key]).to(dev)
    elif cfg.novelty == "rnd":
        rnd = RndPair(cfg)
        p, s = bundle_np["rnd_params"], bundle_np["rnd_batch_stats"]
        for name in ("predictor", "target"):
            _rnd_tower(getattr(rnd, name), p[name], s.get(name, {}))
        bundle["rnd"] = rnd.to(dev).eval()
        bundle["rnd_min"] = _t(bundle_np["rnd_min"]).to(dev)
        bundle["rnd_max"] = _t(bundle_np["rnd_max"]).to(dev)
    elif cfg.novelty == "ensemble":
        ens = EnsembleHeads(cfg)
        for i, head in enumerate(ens.heads):
            _head(head, bundle_np["ensemble_params"][f"head_{i}"])
        bundle["ensemble"] = ens.to(dev).eval()
    return bundle
