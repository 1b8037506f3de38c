from .ops import chunk_hash32, chunk_hash32_device, hash_words_np
from .ref import finalize as finalize_ref
from .ref import mix_terms_np
