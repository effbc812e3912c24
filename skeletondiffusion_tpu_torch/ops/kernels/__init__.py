"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper module holds the kernel's plain PyTorch version beside it and a
plain-integer ``launches`` counter.  A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel (built by
``build.py`` with ``nvcc`` at first use) or raises — it never falls back.
The wrappers on the predictor paths call their kernels through
``torch.library`` custom ops (``skd::<name>``, ``build.kernel_op``), so that
``torch.export`` keeps each launch as one node (``serving.py``); B8 and L1,
off those paths, are called directly.

* ``gru_rollout``     — the 120-step graph-GRU decode in fp32
  (``csrc/gru_rollout.cu``) and, with ``compute_dtype=torch.bfloat16``, the
  merged-gate bf16 rollout (``csrc/gru_rollout_merged.cu``), which only the
  decode check (``scripts/torch_decode_bf16_check.py``) runs; and
  ``decode_rollout``, the decoder's decode around either
* ``posterior_step``  — one reverse-diffusion posterior update, x̂₀ in fp32
  or bf16 (``csrc/posterior_step.cu``)
* ``graph_linear_fused`` — the fused denoiser's stem (``csrc/graph_linear_fused.cu``)
* ``resnet_block``    — its ResnetBlocks and the final block with the output
  head (``csrc/resnet_block.cu``)
* ``attention_proj``  — RMSNorm + qkv projection, output projection +
  residual (``csrc/attention_proj.cu``)
* ``joint_attention`` — attention over the joints (``csrc/joint_attention.cu``)
* ``layer_fused``     — the per-layer kernels of ``SKELDIFF_LAYER_FUSED=1``:
  stem + block, RMSNorm + qkv + attention, out-projection + block
  (``csrc/layer_fused.cu``)
* ``denoiser_fused``  — the denoiser forward as the chain of those kernels
* ``attention_core_fm`` — attention over the joints in the feature-major
  layout (``csrc/attention_core_fm.cu``): a lab kernel on no predictor path,
  driven by ``scripts/torch_attn_core_lab.py``

The fused denoiser's kernels run on the product-and-mix engine of
``csrc/node_mix_sm90.cuh`` (host side ``node_mix_sm90``); the attention
kernel, the fused RMSNorm + qkv + attention kernel and the feature-major
attention core share the bodies of ``csrc/joint_attention.cuh``;
``csrc/node_mix.cuh`` holds the element conversions they all take and the
skeleton's node count, a build parameter: ``build.py`` builds each source
for each count a run asks for (16 H36M, 17 FreeMan, 21 AMASS, 51
AMASS-MANO; 2 to 51 for every source, past 21 the kernels' second designs),
and a wrapper launches the library built at its tensors' count.
"""
