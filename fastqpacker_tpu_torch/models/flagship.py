"""Codec model registry: named end-to-end pipeline configurations.

The port's copy of ``fastqpacker_tpu/models/flagship.py``: the same
models, fields and text; :meth:`CodecModel.options` gives the port's
``pipeline.api.Options``.

A "model" here is a complete codec pipeline specification — container
version, per-stream entropy codecs, dense-transform backend policy — the
analog of a model family in a training framework. The flagship model is
the default production pipeline; the compat model is wire-compatible with
the Go fqpack reference.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..format import container


@dataclass(frozen=True)
class CodecModel:
    name: str
    version: int
    description: str
    stream_codecs: tuple[str, ...]  # wire order: seq qual headers plus npos lengths
    wide_npos: bool  # u32 N positions (no 65,536 bp cap)
    block_crc32: bool

    max_ratio: bool = False  # order-1/2 qual competition + stronger zstd

    def options(self, block_size: int = 0, workers: int = 0):
        from ..pipeline import api

        return api.Options(
            block_size=block_size,  # 0 -> auto (api.resolve_block_size)
            workers=workers,
            version=self.version,
            order1_qual=self.max_ratio,
        )


FQZ_V2_ZSTD = CodecModel(
    name="fqz-v2-zstd",
    version=container.VERSION_2,
    description=(
        "fqpack-compatible FQZ v2: zstd-1 streams with frame checksums; "
        "readable by the Go reference implementation"
    ),
    stream_codecs=("zstd", "zstd", "zstd", "zstd", "zstd", "zstd"),
    wide_npos=False,
    block_crc32=False,
)

FQZ_V3_NATIVE = CodecModel(
    name="fqz-v3-native",
    version=container.VERSION_3_NATIVE,
    description=(
        "TPU-native FQZ v3: per-stream empirical codec picks — order-k "
        "context-modeled rANS for sequences (TAG_SCTX), order-1 "
        "context-modeled or interleaved-lane rANS for qualities "
        "(TAG_QCTX/TAG_RANS), token-delta headers (TAG_TOK), zstd for "
        "the LZ-friendly side streams — explicit per-block CRC32, u32 "
        "N positions (long reads)"
    ),
    # must mirror pipeline.native.STREAM_CODECS (asserted in tests)
    stream_codecs=("seq", "rans", "tok", "zstd", "zstd", "zstd"),
    wide_npos=True,
    block_crc32=True,
)

FQZ_V3_MAX = CodecModel(
    name="fqz-v3-max",
    version=container.VERSION_3_NATIVE,
    description=(
        "FQZ v3 tuned for ratio (CLI --max-ratio): the context-model "
        "competition is opened to every stream and zstd-coded streams "
        "use level 9; slower compress, best size"
    ),
    stream_codecs=FQZ_V3_NATIVE.stream_codecs,
    wide_npos=True,
    block_crc32=True,
    max_ratio=True,
)

FQZ_V3_MESH = CodecModel(
    name="fqz-v3-mesh",
    version=container.VERSION_3_NATIVE,
    description=(
        "FQZ v3 with the entropy stage ON the device mesh (CLI --mesh): "
        "seq/qual streams rANS-coded one block per device per round "
        "(parallel.mesh.entropy_encode_streams), side streams host zstd; "
        "the container is standard v3 — decode needs no mesh"
    ),
    stream_codecs=("rans", "rans", "zstd", "zstd", "zstd", "zstd"),
    wide_npos=True,
    block_crc32=True,
)

FLAGSHIP = FQZ_V2_ZSTD  # default output format (interop first)

REGISTRY = {
    m.name: m
    for m in (FQZ_V2_ZSTD, FQZ_V3_NATIVE, FQZ_V3_MAX, FQZ_V3_MESH)
}

# CLI --format aliases
ALIASES = {"zstd": FQZ_V2_ZSTD.name, "native": FQZ_V3_NATIVE.name}


def get_model(name: str) -> CodecModel:
    key = ALIASES.get(name, name)
    if key not in REGISTRY:
        raise KeyError(
            f"unknown codec model {name!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[key]
