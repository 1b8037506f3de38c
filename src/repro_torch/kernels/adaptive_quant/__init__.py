from .ops import (
    ADAPTIVE_QUANT_LAUNCHES,
    PackedQuant,
    adaptive_quant,
    adaptive_quant_cuda,
    quant_codes,
    quant_pack,
)
