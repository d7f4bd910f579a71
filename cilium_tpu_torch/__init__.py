"""cilium_tpu_torch — the policy-verdict framework on PyTorch and CUDA.

A port of ``cilium_tpu`` (JAX) to an NVIDIA Hopper GPU. The host
modules (labels, policy, identity, compiler, ipcache) are copies of
the JAX package's; the device work runs on hand-written CUDA kernels
(``csrc/``, built by ``_kernels.py`` at first use), each with a plain
PyTorch version of the same function that the CPU path runs.

Entry points (``engine.PolicyEngine``, ``datapath.pipeline.
DatapathPipeline``) take ``device=None``, which means the card; only an
explicit ``device="cpu"`` runs the plain versions.
"""

__version__ = "0.1.0"
