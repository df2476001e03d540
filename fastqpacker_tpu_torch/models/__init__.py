from .flagship import (
    ALIASES,
    FLAGSHIP,
    FQZ_V2_ZSTD,
    FQZ_V3_MAX,
    FQZ_V3_MESH,
    FQZ_V3_NATIVE,
    REGISTRY,
    CodecModel,
    get_model,
)

__all__ = [
    "ALIASES",
    "FLAGSHIP",
    "FQZ_V2_ZSTD",
    "FQZ_V3_MAX",
    "FQZ_V3_MESH",
    "FQZ_V3_NATIVE",
    "REGISTRY",
    "CodecModel",
    "get_model",
]
