"""DiffSensei in PyTorch for one NVIDIA H100: the port of ``diffsensei_tpu``.

The package keeps the JAX package's layout (``core/``, ``ops/``, ``models/``,
``pipelines/``, ``serve/``, ``utils/``) and module names, so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax``.

Public layouts follow the JAX package: NHWC latents and images, attention over
``[batch, heads, seq, head_dim]``. The hand-written kernels sit in ``csrc/``
(flash-attention forward in CUDA C++, GroupNorm+SiLU in Triton) and are built
at first use on the card; on CPU tensors every kernel wrapper runs its plain
PyTorch twin.

Entry points: ``diffsensei_tpu_torch.serve.api.DiffSenseiServer`` and
``diffsensei_tpu_torch.pipelines.pipeline.DiffSenseiPipeline``.
"""

__version__ = "0.1.0"
