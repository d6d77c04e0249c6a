"""PyTorch/CUDA port of ``takzero_tpu``.

Module paths mirror the JAX package (``takzero_torch/tak/engine.py`` is the
counterpart of ``takzero_tpu/tak/engine.py`` and so on).  The port imports
``torch`` and numpy only; it never imports JAX, flax or ``takzero_tpu``.

Entry points (``new_agent``, ``make_net_evaluate``, ``SelfplayEngine``,
``takzero_torch.bench``) run on the CUDA card unless the caller passes
``device="cpu"``; they raise when CUDA is requested but missing.
"""
