"""Port vs JAX package: the sharded programs of ``parallel/mesh.py``.

The JAX package runs them as ``shard_map`` programs on a virtual 8-device
CPU mesh (``tests/conftest.py``); the port runs one shard per entry of a
list of 8 CPU devices, each through its kernels' plain versions. The same
seeded batches go to both, and every array, offset, total and state must
be equal (``tests/test_parallel.py`` holds the JAX side to the numpy
reference).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastqpacker_tpu.ops import rans as jrans
from fastqpacker_tpu.ops import reference as refops
from fastqpacker_tpu.parallel import mesh as jmesh
from fastqpacker_tpu_torch.parallel import mesh as pmesh
from torch_wctx_inputs import one_torch_thread  # noqa: F401  (fixture)
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

D = 8


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= D, "conftest should provide 8 CPU devices"
    return jmesh.make_mesh(D), pmesh.make_mesh(D, device="cpu")


def _batch(d, r, l, seed=0, varlen=False):
    rng = np.random.default_rng(seed)
    ab = np.frombuffer(b"ACGTNacgtn", np.uint8)
    seq = ab[rng.integers(0, 10, size=(d * r, l))].astype(np.uint8)
    qual = rng.integers(33, 75, size=(d * r, l)).astype(np.uint8)
    lengths = (rng.integers(0, l + 1, d * r) if varlen else np.full(d * r, l)).astype(np.int32)
    return seq, qual, lengths


@pytest.mark.parametrize("r,l,varlen", [(16, 64, False), (4, 32, False), (9, 151, True),
                                        (1, 1, False)])
def test_sharded_encode_equals_jax_and_the_reference(meshes, r, l, varlen):
    jm, pm = meshes
    seq, qual, lengths = _batch(D, r, l, seed=r * l, varlen=varlen)
    encs, offsets = pmesh.encode_blocks_parallel(seq, qual, lengths, 33, pm)
    assert len(encs) == D and all(e.packed.shape[0] == r for e in encs)
    got = pmesh.gather_encoded(encs)
    jenc, joffsets = jmesh.encode_blocks_parallel(seq, qual, lengths, 33, jm)
    ref = refops.encode_block_arrays(seq, qual, lengths, 33)
    for name in ("packed", "nmask_bits", "n_counts", "qual_delta"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(jenc, name)))
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert offsets.dtype == np.int64
    np.testing.assert_array_equal(offsets, np.asarray(joffsets))


def test_sharded_offsets_are_exclusive_prefix(meshes):
    _, pm = meshes
    r, l = 4, 32
    seq, qual, lengths = _batch(D, r, l, seed=1)
    _, offsets = pmesh.encode_blocks_parallel(seq, qual, lengths, 33, pm)
    per_shard = r * ((l + 3) // 4) + r * l + 4 * r
    np.testing.assert_array_equal(offsets, np.arange(D, dtype=np.int64) * per_shard)


def test_sharded_decode_roundtrip_equals_jax(meshes):
    jm, pm = meshes
    seq, qual, lengths = _batch(D, 8, 40, seed=2)
    seq = np.where(np.isin(seq, list(b"Nn")), ord("A"), seq & 0xDF).astype(np.uint8)
    encs, _ = pmesh.encode_blocks_parallel(seq, qual, lengths, 33, pm)
    s, q = pmesh.decode_sharded(
        [e.packed for e in encs], [e.qual_delta for e in encs],
        pmesh.shard_rows(lengths, pm), qual_offset=33, mesh=pm)
    np.testing.assert_array_equal(pmesh.gather_rows(s), seq)
    np.testing.assert_array_equal(pmesh.gather_rows(q), qual)
    jenc, _ = jmesh.encode_blocks_parallel(seq, qual, lengths, 33, jm)
    js, jq = jmesh.decode_sharded(jenc.packed, jenc.qual_delta, jnp.asarray(lengths),
                                  qual_offset=33, mesh=jm)
    np.testing.assert_array_equal(pmesh.gather_rows(s), np.asarray(js))
    np.testing.assert_array_equal(pmesh.gather_rows(q), np.asarray(jq))


def test_shards_stay_on_their_devices(meshes):
    _, pm = meshes
    seq, qual, lengths = _batch(D, 4, 32, seed=3)
    encs, _ = pmesh.encode_blocks_parallel(seq, qual, lengths, 33, pm)
    assert {e.packed.shape[0] for e in encs} == {4}
    assert all(e.packed.device == dev for e, dev in zip(encs, pm))


def test_uneven_batch_rejected(meshes):
    jm, pm = meshes
    seq, qual, lengths = _batch(1, 9, 16)
    with pytest.raises(ValueError, match="not divisible") as got:
        pmesh.encode_blocks_parallel(seq, qual, lengths, 33, pm)
    with pytest.raises(ValueError) as want:
        jmesh.encode_blocks_parallel(seq, qual, lengths, 33, jm)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("m,lanes,ragged", [(1024, 256, False), (1000, 256, True),
                                            (4096, 1024, True), (300, 256, True)])
def test_sharded_entropy_equals_jax(meshes, m, lanes, ragged):
    """Per-shard rANS encode with the word totals gathered into offsets, and
    the decode: words ``[:total]``, states, totals and offsets equal the JAX
    programs', the round trip is exact."""
    jm, pm = meshes
    rng = np.random.default_rng(31 + m)
    streams = rng.integers(0, 40, (D, m)).astype(np.uint8)
    raw_lens = None
    if ragged:
        raw_lens = rng.integers(0, m + 1, D).astype(np.int32)
        raw_lens[0] = 0
    freq_cum, pad_sym = jmesh.entropy_table(streams, raw_lens=raw_lens, lanes=lanes)
    pf, pp = pmesh.entropy_table(streams, raw_lens=raw_lens, lanes=lanes)
    np.testing.assert_array_equal(pf, freq_cum)
    assert pp == pad_sym
    if ragged:  # rows padded with the pad symbol past their length, as JAX asks
        for i, n in enumerate(raw_lens):
            streams[i, n:] = pad_sym
    got = pmesh.entropy_encode_sharded(streams, freq_cum, raw_lens, mesh=pm, pad_sym=pad_sym,
                                       m_per_shard=m, lanes=lanes)
    jl = None if raw_lens is None else jnp.asarray(raw_lens)
    words, states, totals, offsets = jmesh.entropy_encode_sharded(
        jnp.asarray(streams), jnp.asarray(freq_cum), jl, mesh=jm, pad_sym=pad_sym,
        m_per_shard=m, lanes=lanes)
    words, states = np.asarray(words), np.asarray(states)
    np.testing.assert_array_equal(got.totals, np.asarray(totals))
    np.testing.assert_array_equal(got.offsets, np.asarray(offsets))
    np.testing.assert_array_equal(got.offsets, np.cumsum(got.totals) - got.totals)
    assert got.totals.dtype == got.offsets.dtype == np.int64
    for i in range(D):
        t = int(got.totals[i])
        np.testing.assert_array_equal(got.words[i][:t].numpy().view(np.uint16), words[i, :t])
        np.testing.assert_array_equal(got.states[i].numpy().view(np.uint32), states[i])

    out = pmesh.entropy_decode_sharded(got.words, got.states, freq_cum, raw_lens, mesh=pm,
                                       m_per_shard=m, lanes=lanes)
    lens = np.full(D, m) if raw_lens is None else raw_lens
    for i in range(D):
        np.testing.assert_array_equal(out[i].numpy()[: lens[i]], streams[i, : lens[i]])
    if raw_lens is None:
        tabs = jrans.compact_tables(freq_cum[0].astype(np.uint16))
        jout = jmesh.entropy_decode_sharded(
            jnp.asarray(words), jnp.asarray(states), jnp.asarray(tabs), mesh=jm,
            m_per_shard=m, lanes=lanes)
        np.testing.assert_array_equal(pmesh.gather_rows(out).reshape(D, m), np.asarray(jout))


def test_for_each_device_runs_each_entry_on_a_thread_of_its_own():
    """The dispatcher with threads on a CPU mesh of four entries: the four
    calls overlap (each waits at a barrier the others must reach), results
    come back in list order, ``None`` items are skipped, and an error of
    one entry is raised after all ended."""
    mesh = pmesh.make_mesh(4, device="cpu")
    barrier = threading.Barrier(3, timeout=30)
    seen = []

    def fn(dev, item):
        seen.append(threading.get_ident())
        barrier.wait()
        return item * 10

    assert pmesh.for_each_device(mesh, fn, [1, None, 3, 4], threads=True) == [10, None, 30, 40]
    assert len(set(seen)) == 3 and threading.get_ident() not in seen

    def failing(dev, item):
        if item == 2:
            raise ValueError("entry 2")
        return item

    with pytest.raises(ValueError, match="entry 2"):
        pmesh.for_each_device(mesh, failing, [1, 2, 3, 4], threads=True)
    # on a CPU mesh the default is the calling thread, one entry after another
    caller = []
    pmesh.for_each_device(mesh, lambda dev, item: caller.append(threading.get_ident()), [1] * 4)
    assert set(caller) == {threading.get_ident()}
    with pytest.raises(ValueError, match="need 4 items"):
        pmesh.for_each_device(mesh, fn, [1, 2])


def test_threaded_stream_apis_give_the_same_payloads(monkeypatch, one_torch_thread):
    """The four stream APIs through the dispatcher with threads on a CPU mesh
    of four entries give the payloads of the calling thread."""
    from fastqpacker_tpu_torch.ops import wctx

    mesh = pmesh.make_mesh(4, device="cpu")
    rng = np.random.default_rng(7)
    streams = [rng.integers(0, 30, int(n)).astype(np.uint8).tobytes() for n in (5000, 0, 3000, 700)]
    lens = [np.full(10, 20), np.full(12, 10), np.full(8, 15), np.full(20, 5)]
    jobs = [(rng.integers(0, 4, int(l.sum())).astype(np.uint8), l, None) for l in lens]
    jobs = [(s, l, np.bincount(s, minlength=256).reshape(1, 256).repeat(16, 0)) for s, l, _ in jobs]
    want = (pmesh.entropy_encode_streams(streams, mesh),
            pmesh.wctx_encode_streams(jobs, wctx.MODEL_SEQ, 2, mesh, lanes=32))
    orig = pmesh.for_each_device
    threaded = []

    def with_threads(m, f, items, threads=None):
        threaded.append(len(items))
        return orig(m, f, items, True)

    monkeypatch.setattr(pmesh, "for_each_device", with_threads)
    got = (pmesh.entropy_encode_streams(streams, mesh),
           pmesh.wctx_encode_streams(jobs, wctx.MODEL_SEQ, 2, mesh, lanes=32))
    assert got == want
    assert pmesh.entropy_decode_streams(got[0], mesh) == streams
    flats = pmesh.wctx_decode_streams(got[1], lens, mesh)
    # the order-0 encode's upload (its table is counted where the streams
    # lie), launch + fetch of both encodes, both decodes
    assert threaded == [4] * 7
    for flat, (syms, _, _) in zip(flats, jobs):
        np.testing.assert_array_equal(flat, syms)
