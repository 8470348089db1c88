"""CoQMoE in PyTorch with hand-written CUDA kernels for Hopper (H100).

The port of the JAX package ``repro``, module by module in the same layout
(``configs``, ``core/quant``, ``core/moe``, ``kernels``, ``models``,
``serving``). It imports neither ``jax`` nor ``repro``; weights cross
between the two as numpy arrays (``repro_torch.bridge``). Every kernel
wrapper launches its CUDA kernel for CUDA tensors and the entry points
(``init_model_params``, ``ViTClassifier``, ``VisionEngine``) run on the card
unless ``device="cpu"`` is passed.
"""
