from .ops import PackedQuant, quant_codes, quant_pack
