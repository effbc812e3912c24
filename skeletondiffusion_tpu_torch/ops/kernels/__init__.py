"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper module holds the kernel's plain PyTorch version beside it and a
plain-integer ``launches`` counter.  A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel (built by
``build.py`` with ``nvcc`` at first use) or raises — it never falls back.

* ``gru_rollout``     — the 120-step graph-GRU decode (``csrc/gru_rollout.cu``)
* ``posterior_step``  — one reverse-diffusion posterior update
  (``csrc/posterior_step.cu``)
"""
