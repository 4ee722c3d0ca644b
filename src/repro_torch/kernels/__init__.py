"""Hand-written Hopper kernels for the compute hot-spots:

  tsmm             — G = X^T X (+ reg I), half-compute (paper's flagship op)
  flash_attention  — blockwise online-softmax attention (prefill hot-spot),
                     and its backward (flash_attention_bwd)
  ssd_scan         — Mamba2 SSD chunked scan (prefill hot-spot of the SSMs),
                     and its backward (ssd_scan_bwd)
  matmul_epilogue  — matmul with a fused bias/silu/gelu/layernorm epilogue
                     and cast sinking (the MLP gate, the fp32-logit head)

``ops`` holds the public wrappers; each kernel's module holds the wrapper that
launches it, its plain PyTorch version and its launch count.  The CUDA sources
are under ``csrc/`` and are built at first use (``_build``).  Every TPU
kernel of the reference has its counterpart here; the two backward kernels
are the port's own (the reference differentiates its plain path).
"""
