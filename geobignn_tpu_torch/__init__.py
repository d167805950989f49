"""geobignn_tpu_torch — the PyTorch/CUDA port of geobignn_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  It imports
torch, numpy and scipy and nothing of JAX or of `geobignn_tpu`.  Entry points
(`infer.predict.Predictor`, `train.trainer.Trainer`,
`models.dual_gnn.DualGNN`) run on CUDA by default and raise when no GPU is
present unless the caller passes device="cpu"; the banded aggregate
(ops/banded_cuda.py) launches its hand-written Hopper kernels, forward and
backward, for CUDA tensors and runs its plain PyTorch versions for CPU
tensors.

TF32 is switched off for float32 matrix products and convolutions when the
package is loaded: the port's float32 products are full float32, as its
parity tests against the JAX package assume.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
