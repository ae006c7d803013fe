"""``LoRADense`` base path (port of ``diffsensei_tpu/models/lora.py:43``).

The slice serves rank-0, unquantized weights, where ``LoRADense`` is a dense
layer: ``x @ W + b``. Here it is ``nn.Linear`` under the same names
(``weight``, ``bias``). LoRA adapters and the int8 branch wait for a later
slice; LoRA-trained JAX trees are merged first
(``diffsensei_tpu.models.lora.merge_lora_params``).
"""

from __future__ import annotations

from torch import nn


class LoRADense(nn.Linear):
    """Rank-0 ``LoRADense``: a plain ``nn.Linear``."""
