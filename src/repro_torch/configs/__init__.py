"""The LM zoo's configs: the port's copy of ``src/repro/configs``.

Data, copied whole: every module exports CONFIG (a ``ModelConfig``) with
the published shape of its architecture; REGISTRY maps the launcher's
``--arch`` ids to them, so ``--arch`` offers the reference's ten
choices, and ``models.registry.get_model`` runs each on one device.
"""

from repro_torch.configs import (deepseek_coder_33b, deepseek_moe_16b,
                                 granite_moe_3b_a800m, internlm2_20b,
                                 mamba2_370m, minicpm3_4b, pixtral_12b,
                                 qwen1_5_0_5b, whisper_base, zamba2_1_2b)
from repro_torch.configs.shapes import SHAPES, Shape, cells, shape_applicable

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (mamba2_370m, deepseek_moe_16b, granite_moe_3b_a800m,
              zamba2_1_2b, qwen1_5_0_5b, deepseek_coder_33b, minicpm3_4b,
              internlm2_20b, pixtral_12b, whisper_base)
}

__all__ = ["REGISTRY", "SHAPES", "Shape", "cells", "shape_applicable"]
