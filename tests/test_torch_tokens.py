"""The port's header tokenizer (``fq_tok_encode`` / ``fq_tok_decode``,
``csrc/tokens.cu``) against the JAX package's, on the CPU.

The header streams of seeded inputs (SIM names, Illumina names of random
width, names in instrument order, and the edges of ``torch_tokens_inputs``)
go through ``fastqpacker_tpu.ops.tokenize`` (the pure Python that defines
the wire format), the JAX runtime's ``tok_encode`` / ``tok_decode`` (C++,
built on first use) and the port's ``tokenize.encode`` / ``decode`` on the
CPU, where ``cuda_kernels.tok_encode`` / ``tok_decode`` run their plain
versions. Every decode fault's string equals the JAX package's pure Python
one. The v3 container of the ordered-name corpus equals the JAX package's
with one worker, its header streams ``TAG_TOK``. All comparisons are exact.
"""

import io

import numpy as np
import pytest
import torch

import fastqpacker_tpu as jfq
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu.ops import tokenize as jtok
from fastqpacker_tpu.runtime import bindings
from fastqpacker_tpu_torch.format import container
from fastqpacker_tpu_torch.ops import cuda_kernels
from fastqpacker_tpu_torch.ops import tokenize as ttok
from fastqpacker_tpu_torch.pipeline import native as tnative
from fastqpacker_tpu_torch.utils import synth
import torch_tokens_inputs
from torch_tokens_inputs import decode_fault_cases, header_edge_cases, headers_of, stream_of
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

CPU = torch.device("cpu")
HEADERS = header_edge_cases()
FAULTS = decode_fault_cases()


def _t(b: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(b, np.uint8).copy())


@pytest.mark.parametrize("name,const", [
    ("ENCODE_TILE_RECORDS", "kEncRecords"), ("TILE_RECORDS", "kTokRecords"),
    ("TILE_COLUMNS", "kTokCols"), ("CHAIN_TILE", "kChainTile"), ("CHAIN_WINDOW", "kWindow"),
])
def test_edge_inputs_follow_the_kernel_tiling(name, const):
    """The edges are cut at the kernels' tiles: the sizes they are cut at
    equal the constants of ``csrc/tokens.cu``."""
    import re
    from pathlib import Path

    src = (Path(ttok.__file__).parent.parent / "csrc" / "tokens.cu").read_text()
    m = re.search(rf"constexpr int {const} = (\d+);", src)
    assert m and int(m.group(1)) == getattr(torch_tokens_inputs, name)


@pytest.mark.parametrize("case", sorted(HEADERS))
def test_encode_equals_the_jax_package(case):
    """The tokenized stream equals the JAX package's pure Python and its C++
    runtime's, for host bytes and for a tensor view at an odd offset."""
    headers = HEADERS[case]
    s = stream_of(headers)
    want = jtok.encode(s, len(headers))
    assert ttok.encode(s, len(headers), device=CPU) == want
    view = _t(b"\x07" + s + b"\x09")[1 : 1 + len(s)]
    assert ttok.encode(view, len(headers)) == want
    assert cuda_kernels.tok_encode(view, len(headers)).numpy().tobytes() == want
    if bindings.available():
        assert bindings.tok_encode(s, len(headers)) == want


@pytest.mark.parametrize("case", sorted(HEADERS))
def test_decode_equals_the_jax_package(case):
    """The tokenized stream decodes to the header stream, as the JAX
    package's pure Python and C++ runtime decode it."""
    headers = HEADERS[case]
    s = stream_of(headers)
    tok = jtok.encode(s, len(headers))
    assert ttok.decode(tok, len(headers), device=CPU) == s
    assert cuda_kernels.tok_decode(_t(tok), len(headers)).numpy().tobytes() == s
    assert jtok.decode(tok, len(headers)) == s
    if bindings.available():
        assert bindings.tok_decode(tok, len(headers)) == s


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_decode_fault_strings_equal_the_jax_package(case):
    """Each of the plain decoder's nine faults (and streams whose bytes past
    the last record are never read) gives the JAX package's pure-Python
    string or output."""
    data, count = FAULTS[case]
    try:
        want = jtok.decode(data, count)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ttok.decode(data, count, device=CPU)
        assert str(got.value) == str(e)
        assert not case.startswith("ok_")
    else:
        assert ttok.decode(data, count, device=CPU) == want
        assert case.startswith("ok_")


def test_every_decode_fault_string_is_covered():
    """The fault cases reach all nine strings of the plain decoder."""
    seen = set()
    for data, count in FAULTS.values():
        try:
            jtok.decode(data, count)
        except ValueError as e:
            seen.add(str(e).split(":")[0] if str(e).startswith("unknown") else str(e))
    want = {s.split(":")[0] if s.startswith("unknown") else s for s in ttok.TOK_FAULTS.values()}
    assert seen == want and len(want) == 9


@pytest.mark.parametrize("stream,count", [
    (stream_of([b"a", b"b"]), 3),
    (stream_of([b"a", b"b"])[:-1], 2),
    (stream_of([b"a", b"b"]) + b"\x00", 2),
    (stream_of([b"a", b"b"]), 1),
    (b"\x05", 1),
    (b"", 1),
    (b"\x00\x00", 0),
])
def test_encode_fault_strings_equal_the_jax_package(stream, count):
    """A truncated stream and trailing bytes after the last record: the
    plain version's strings, which the v3 header pick catches (zstd)."""
    with pytest.raises(ValueError) as want:
        jtok.encode(stream, count)
    with pytest.raises(ValueError) as got:
        ttok.encode(stream, count, device=CPU)
    assert str(got.value) == str(want.value)


def test_encode_header_pick_falls_back_on_a_malformed_stream_only():
    """``_encode_tagged_headers`` codes a malformed header stream with zstd
    (the wire's choice), and a sound one from its view in a buffer with the
    JAX package's pick."""
    from fastqpacker_tpu.entropy import zstd as jzstd
    from fastqpacker_tpu.pipeline import native as jnative
    from fastqpacker_tpu_torch.entropy import zstd

    codec = zstd.get_codec()
    headers = HEADERS["corpus_ordered"]
    s = stream_of(headers)
    bad = tnative._encode_tagged_headers(s[:-1], _t(s[:-1]), len(headers), codec)
    assert bad[0] == tnative.TAG_ZSTD
    good = tnative._encode_tagged_headers(s, _t(b"\x01" + s)[1:], len(headers), codec)
    assert good == jnative._encode_tagged_headers(s, len(headers), jzstd.get_codec())
    assert good[0] == tnative.TAG_TOK


def _tags(comp: bytes) -> list:
    r = io.BytesIO(comp)
    fh = container.read_file_header(r)
    tags = []
    while (hdr := container.read_block_header(r, fh.version)) is not None:
        sizes = hdr.stream_sizes(container.VERSION_2)
        payload = r.read(sum(sizes))
        tags.append(payload[sizes[0] + sizes[1]])
    return tags


def test_ordered_names_v3_container_equals_the_jax_package():
    """Names in instrument order pick the tokenizer on every block; the v3
    container equals the JAX package's with one worker, and decodes."""
    data = synth.ordered_illumina_fastq(12_000, seed=5)
    comp = tfq.compress_bytes(data, tfq.Options(version=3, block_size=5000, workers=1),
                              device=CPU)
    want = jfq.compress_bytes(data, jfq.Options(version=3, block_size=5000, workers=1))
    assert comp == want
    assert _tags(comp) == [tnative.TAG_TOK] * 3
    assert tfq.decompress_bytes(comp, device=CPU) == data


@pytest.mark.parametrize("records,seed", [(1, 0), (4000, 1), (4001, 2), (9000, 3)])
def test_ordered_names_follow_instrument_order(records, seed):
    """One lane, tiles in order of 4,000 records, y ascending within a
    tile from 1,000, x of 4-5 digits, one read and index."""
    heads = headers_of(synth.ordered_illumina_fastq(records, seed=seed))
    assert len(heads) == records
    fields = [h.split(b" ")[0].split(b":") for h in heads]
    assert {h.split(b" ")[1] for h in heads} == {heads[0].split(b" ")[1]}
    assert all(f[3] == b"1" for f in fields)
    tiles = [int(f[4]) for f in fields]
    assert tiles == sorted(tiles) and tiles[0] == 1101
    for k in range(records):
        x, y = int(fields[k][5]), int(fields[k][6])
        assert 1000 <= x <= 32999
        if k % 4000 == 0:
            assert y == 1000
        else:
            assert tiles[k] == tiles[k - 1] and y >= int(fields[k - 1][6])


def test_jax_runtime_is_loaded_again_after_a_failed_load(monkeypatch):
    """A test process that met the JAX runtime while another was writing it
    (``bindings`` remembers the failed load) loads it again: the port's
    tests that compare with the runtime keep their reference."""
    from torch_jax_runtime import ensure

    if not ensure():
        pytest.fail("the JAX runtime does not build here")
    monkeypatch.setattr(bindings, "_lib", None)
    monkeypatch.setattr(bindings, "_tried", True)
    assert not bindings.available()
    assert ensure() and bindings.available()
    assert bindings.tok_encode(stream_of([b"r:1", b"r:2"]), 2) == jtok.encode(
        stream_of([b"r:1", b"r:2"]), 2)
