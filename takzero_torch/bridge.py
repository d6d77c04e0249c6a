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

The same naming, :func:`jax_checkpoint_state`, reads a JAX run's
``model_*.ckpt`` into the port's checkpoint layout (``utils/ckpt.py``,
through ``utils/flax_msgpack.py``).  This module needs neither JAX nor
flax: the bundle is plain nested dicts of numpy arrays.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .device import resolve_device
from .models.network import EnsembleHeads, NetConfig, RndPair, TakNet, fold_inference_params

MODULES = {"params": "net", "rnd_params": "rnd", "ensemble_params": "ensemble"}
STATS = {"batch_stats": "net", "rnd_batch_stats": "rnd"}
# JAX leaf -> the port's state-dict leaf.
_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight", "mean": "running_mean", "var": "running_var"}


def _segment(path: tuple, name: str) -> str:
    """The port's submodule name of the flax module ``name`` under ``path``."""
    parent = path[-1] if path else ""
    if name == "ConvBN_0":
        return "a" if parent.startswith("ResBlock_") else "stem"
    if name == "ConvBN_1":
        return "b" if parent.startswith("ResBlock_") else "head"
    if name == "Conv_0":
        return "policy" if not path else "conv"
    if name.startswith("Dense_"):
        return f"layers.{name[6:]}" if parent in ("predictor", "target") else "dense"
    m = re.fullmatch(r"(ResBlock|head)_(\d+)", name)
    if m:
        return f"{'blocks' if m.group(1) == 'ResBlock' else 'heads'}.{m.group(2)}"
    return {"BatchNorm_0": "bn", "LayerNorm_0": "norm"}.get(name, name)


def _leaf(x) -> torch.Tensor:
    """A kernel from HWIO to OIHW (convolutions) or [in, out] to [out, in]
    (dense layers), as float32."""
    a = np.array(x, dtype=np.float32)
    if a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))
    elif a.ndim == 2:
        a = a.T
    return torch.from_numpy(np.ascontiguousarray(a))


def _walk(tree: dict, path: tuple, out: dict) -> None:
    for name, v in tree.items():
        if isinstance(v, dict):
            _walk(v, path + (name,), out)
            continue
        key = ".".join([_segment(path[:i], p) for i, p in enumerate(path)] + [_LEAVES.get(name, name)])
        out[key] = _leaf(v) if name == "kernel" else torch.from_numpy(np.array(v, dtype=np.float32))
        if path and path[-1] == "BatchNorm_0" and name == "mean":
            out[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def jax_checkpoint_state(bundle_np: dict) -> dict:
    """The port's checkpoint entries (``utils/ckpt.py``'s layout:
    ``{"net": state dict, "rnd": ..., "ensemble": ..., "hash_matrix": ...}``)
    of a JAX bundle with numpy leaves, named leaf by leaf, so that a file
    of another architecture still gives every leaf it has (the partial
    load keeps the bundle's value where one does not fit).  Leaves the
    port has no place for keep their JAX names."""
    state: dict = {}
    for key, v in bundle_np.items():
        module = MODULES.get(key) or STATS.get(key)
        if module is not None:
            _walk(v, (), state.setdefault(module, {}))
        elif key == "hash_bits":  # uint32 words kept as int32 bit patterns
            words = np.ascontiguousarray(np.asarray(v, np.uint32))
            state[key] = torch.from_numpy(words.view(np.int32).copy())
        else:
            state[key] = torch.from_numpy(np.array(v, dtype=np.float32))
    return state


@torch.no_grad()
def rnd_pair_from_jax(params: dict, batch_stats: dict, cfg: NetConfig, device=None) -> RndPair:
    """The port's :class:`RndPair` holding a JAX ``RndPair``'s variables
    (``params`` and ``batch_stats`` as numpy arrays), in eval mode."""
    rnd = RndPair(cfg)
    rnd.load_state_dict(jax_checkpoint_state({"rnd_params": params, "rnd_batch_stats": batch_stats})["rnd"])
    return rnd.to(resolve_device(device)).eval()


@torch.no_grad()
def from_jax_bundle(bundle_np: dict, cfg: NetConfig, device=None) -> dict:
    """The port's agent bundle holding the JAX bundle's weights and novelty state."""
    dev = resolve_device(device)
    state = jax_checkpoint_state(bundle_np)
    net = TakNet(cfg)
    net.load_state_dict(state["net"])
    net = net.to(dev).eval()
    bundle = {"net": net, "folded": fold_inference_params(cfg, net)}
    if cfg.novelty in ("simhash", "lcghash"):
        bundle["hash_bits"] = state["hash_bits"].to(dev)
        key = "hash_matrix" if cfg.novelty == "simhash" else "hash_scale"
        bundle[key] = state[key].to(dev)
    elif cfg.novelty == "rnd":
        rnd = RndPair(cfg)
        rnd.load_state_dict(state["rnd"])
        bundle["rnd"] = rnd.to(dev).eval()
        bundle["rnd_min"] = state["rnd_min"].to(dev)
        bundle["rnd_max"] = state["rnd_max"].to(dev)
    elif cfg.novelty == "ensemble":
        ens = EnsembleHeads(cfg)
        ens.load_state_dict(state["ensemble"])
        bundle["ensemble"] = ens.to(dev).eval()
    return bundle
