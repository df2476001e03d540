"""The port's codec model registry against the JAX package's.

Every field of every model, the aliases, the flagship and the ``get_model``
error must equal the JAX registry's; each model's ``options()`` through the
port's ``compress_bytes(device="cpu")`` must give the JAX package's
container byte for byte (inputs under 4 MB: ROADMAP Queue C 6).
"""

import dataclasses

import pytest

from fastqpacker_tpu import models as jmodels
from fastqpacker_tpu.pipeline import api as japi
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu_torch import models as pmodels
from fastqpacker_tpu_torch.pipeline import api as papi
from fastqpacker_tpu_torch.pipeline import native as pnative
from fastqpacker_tpu_torch.utils.synth import synth_fastq
from torch_wctx_inputs import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

NAMES = sorted(jmodels.REGISTRY)


def test_registry_names_aliases_and_flagship_equal_jax():
    assert sorted(pmodels.REGISTRY) == NAMES
    assert pmodels.ALIASES == jmodels.ALIASES
    assert pmodels.FLAGSHIP.name == jmodels.FLAGSHIP.name
    assert pmodels.FLAGSHIP is pmodels.FQZ_V2_ZSTD
    for name in ("FQZ_V2_ZSTD", "FQZ_V3_NATIVE", "FQZ_V3_MAX", "FQZ_V3_MESH"):
        assert getattr(pmodels, name).name == getattr(jmodels.flagship, name).name


@pytest.mark.parametrize("name", NAMES)
def test_every_field_equals_jax(name):
    want = dataclasses.asdict(jmodels.REGISTRY[name])
    got = dataclasses.asdict(pmodels.REGISTRY[name])
    assert got == want
    assert [f.name for f in dataclasses.fields(pmodels.CodecModel)] == [
        f.name for f in dataclasses.fields(jmodels.CodecModel)]


@pytest.mark.parametrize("key", [*NAMES, "zstd", "native"])
def test_get_model_resolves_like_jax(key):
    assert pmodels.get_model(key).name == jmodels.get_model(key).name


def test_get_model_error_equals_jax():
    with pytest.raises(KeyError) as jerr:
        jmodels.get_model("nope")
    with pytest.raises(KeyError) as perr:
        pmodels.get_model("nope")
    assert str(perr.value) == str(jerr.value)
    # the ported JAX test (tests/test_native_format.py::test_model_registry)
    assert pmodels.get_model("native").version == tfq.container.VERSION_3_NATIVE
    assert pmodels.get_model("zstd") is pmodels.FLAGSHIP
    assert pmodels.get_model("fqz-v3-native").wide_npos
    assert pmodels.FLAGSHIP.options(block_size=10).version == tfq.container.VERSION_2


def test_native_stream_codecs_mirror_the_port_pipeline():
    assert pmodels.FQZ_V3_NATIVE.stream_codecs == pnative.STREAM_CODECS


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("workers", [0, 3])
def test_options_are_the_port_options_and_equal_jax(name, workers):
    got = pmodels.get_model(name).options(block_size=7, workers=workers)
    want = jmodels.get_model(name).options(block_size=7, workers=workers)
    assert isinstance(got, papi.Options)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", NAMES)
def test_options_through_compress_bytes_equal_jax(name):
    data = synth_fastq(1.5, seed=12, min_len=60, read_len=160)
    assert len(data) < 4 << 20
    got = tfq.compress_bytes(data, pmodels.get_model(name).options(), device="cpu")
    want = japi.compress_bytes(data, jmodels.get_model(name).options())
    assert got == want
    assert tfq.decompress_bytes(got, device="cpu") == data
