"""Port of ``repro.kernels``: the hand-written CUDA kernels (``csrc/``),
their wrappers and plain versions, the device dispatch (``ops.py``) and the
autotuner (``autotune.py``), whose per-device table picks the grouped
kernel's variant and ``lm_attention``'s schedule. An engine tunes at
warmup, before capturing its CUDA graphs, and a captured graph keeps the
picks its capture resolved."""
