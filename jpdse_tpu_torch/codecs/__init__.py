from jpdse_tpu_torch.codecs.bridge import (  # noqa: F401
    CodecUnavailable,
    available_codecs,
    batch_encode_decode,
    compress_for_model,
    decode_bytes,
    encode_bytes,
    encode_decode,
    normalize_decoded,
)
