"""``LoRADense`` base path (port of ``diffsensei_tpu/models/lora.py:43``).

The slice serves rank-0, unquantized weights, where ``LoRADense`` is a dense
layer: ``x @ W + b``. Here it is the port's ``Linear`` (``nn.Linear`` names
``weight``, ``bias``, computing in the input's dtype). LoRA adapters and the int8 branch wait for a later
slice; LoRA-trained JAX trees are merged first
(``diffsensei_tpu.models.lora.merge_lora_params``).
"""

from __future__ import annotations

from diffsensei_tpu_torch.models.layers import Linear


class LoRADense(Linear):
    """Rank-0 ``LoRADense``: a plain ``Linear``."""
