"""karpenter_tpu_torch: the PyTorch/CUDA port of karpenter_tpu.

A second package beside karpenter_tpu (the JAX reference). It imports torch,
numpy and the standard library only, never jax, triton at import time, or
anything of karpenter_tpu; the host modules it needs are its own copies.

Public surface of this slice:

- ``karpenter_tpu_torch.solver.core.TorchSolver`` — the provisioning solve
  (encode -> pack -> one device read -> decode). It runs on the CUDA card by
  default and raises without one; ``device="cpu"`` runs the plain PyTorch
  path, as the tests do.
- ``karpenter_tpu_torch.ops.open_claim.open_claim_fill`` — the pack step's
  open-claim fill, two launches of a CUDA kernel written for the H100
  (csrc/open_claim.cu) that fuse the capacity quotient with its consumers.
- ``karpenter_tpu_torch.ops.quotient.quotient_nt`` — the capacity quotient
  alone, a CUDA kernel (csrc/quotient.cu) the pack step no longer calls.
- ``karpenter_tpu_torch.oracle.scheduler.Scheduler`` — the scalar oracle,
  the spec every solve answers to.
"""

__version__ = "0.1.0"
