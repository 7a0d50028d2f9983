"""The port's ECUtil (``ceph_tpu_torch.ec.stripe``) against
``ceph_tpu.ec.stripe`` on the CPU: ``StripeInfo``'s offset arithmetic,
the stripe-batched encode, decode and recovery through the port's
plugins, ``crc32c`` (the table walker and the native slicing-by-8
engine) and ``HashInfo``.  Every output is bytes or integers: the
tolerance is zero.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as jregistry
from ceph_tpu.ec import stripe as jstripe

from ceph_tpu_torch.ec import registry, stripe
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.stripe import (HashInfo, StripeInfo, crc32c,
                                      crc32c_table, sinfo_for)

CPU = "cpu"


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("k,width", [(2, 8192), (3, 12288), (8, 32768),
                                     (4, 64)])
def test_stripe_info_matches_jax_package(k, width):
    s, js = StripeInfo(k, width), jstripe.StripeInfo(k, width)
    assert (s.stripe_width, s.chunk_size) == (js.stripe_width,
                                              js.chunk_size)
    for off in list(range(0, 3 * width + 1, max(1, width // 7))) + [
            width - 1, width, width + 1]:
        for name in ("logical_offset_is_stripe_aligned",
                     "logical_to_prev_chunk_offset",
                     "logical_to_next_chunk_offset",
                     "logical_to_prev_stripe_offset",
                     "logical_to_next_stripe_offset"):
            assert getattr(s, name)(off) == getattr(js, name)(off), name
        assert s.offset_len_to_stripe_bounds(off, 777) == \
            js.offset_len_to_stripe_bounds(off, 777)
    assert s.aligned_logical_offset_to_chunk_offset(2 * width) == \
        js.aligned_logical_offset_to_chunk_offset(2 * width)
    assert s.aligned_chunk_offset_to_logical_offset(2 * s.chunk_size) == \
        js.aligned_chunk_offset_to_logical_offset(2 * s.chunk_size)
    with pytest.raises(ValueError):
        StripeInfo(3, 8191)


PROFILES = [
    ("jerasure", {"technique": "reed_sol_van", "k": "3", "m": "2"}),
    ("isa", {"k": "4", "m": "2", "mapping": "DD__DD"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
]


@pytest.mark.parametrize("plugin,profile", PROFILES,
                         ids=[p for p, _ in PROFILES])
def test_stripe_encode_decode_recover_match_jax_package(plugin, profile):
    code = registry.factory(plugin, dict(profile), device=CPU)
    jcode = jregistry.factory(plugin, dict(profile))
    si, jsi = sinfo_for(code, 256), jstripe.sinfo_for(jcode, 256)
    assert si.stripe_width == jsi.stripe_width
    buf = _bytes(5 * si.stripe_width, 11)
    enc = stripe.encode(si, code, buf)
    jenc = jstripe.encode(jsi, jcode, buf)
    assert sorted(enc) == sorted(jenc)
    for i in enc:
        assert enc[i].device.type == "cpu"
        assert np.array_equal(enc[i].numpy(), np.asarray(jenc[i]))
    # one stripe at a time through the plain interface gives the same
    n = code.get_chunk_count()
    for s in range(5):
        piece = buf[s * si.stripe_width:(s + 1) * si.stripe_width]
        one = code.encode(range(n), piece)
        for i in range(n):
            assert torch.equal(one[i], enc[i][s * si.chunk_size:
                                             (s + 1) * si.chunk_size])
    lost = {code.chunk_index(0), n - 1}
    surviving = {i: v for i, v in enc.items() if i not in lost}
    got = stripe.recover_stripes(si, code, surviving, lost)
    jgot = jstripe.recover_stripes(jsi, jcode, {
        i: np.asarray(v) for i, v in jenc.items() if i not in lost}, lost)
    for i in lost:
        assert torch.equal(got[i], enc[i])
        assert np.array_equal(got[i].numpy(), np.asarray(jgot[i]))


def test_stripe_errors_match_jax_package():
    code = registry.factory("jerasure", {"k": "2", "m": "1"}, device=CPU)
    si = sinfo_for(code, stripe_unit=64)
    with pytest.raises(ValueError):
        stripe.encode(si, code, b"x" * 100)
    empty = stripe.encode(si, code, b"")
    assert sorted(empty) == [0, 1, 2]
    assert all(v.numel() == 0 for v in empty.values())
    enc = stripe.encode(si, code, _bytes(256, 1))
    with pytest.raises(ValueError):
        stripe.decode(si, code, {0: enc[0], 1: enc[1][:64]}, {2})
    with pytest.raises(ValueError):
        stripe.decode(si, code, {0: enc[0][:10], 1: enc[1][:10]}, {2})
    with pytest.raises(ErasureCodeError) as e:
        stripe.decode(si, code, {0: enc[0]}, {1})
    assert e.value.errno == -5


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 511, 512, 513, 4096, 70001])
@pytest.mark.parametrize("seed", [0xFFFFFFFF, 0, 0x12345678])
def test_crc32c_matches_jax_package(n, seed):
    data = _bytes(n, n)
    want = jstripe.crc32c(data, seed)
    assert crc32c(data, seed) == want
    assert crc32c_table(data, seed) == want
    assert crc32c(np.frombuffer(data, np.uint8), seed) == want
    assert crc32c(torch.from_numpy(np.frombuffer(data, np.uint8).copy()),
                  seed) == want


def test_crc32c_known_vector():
    """CRC-32C (Castagnoli) standard check value; an empty input leaves
    the seed untouched."""
    assert crc32c(b"123456789") ^ 0xFFFFFFFF == 0xE3069283
    assert crc32c_table(b"123456789") ^ 0xFFFFFFFF == 0xE3069283
    assert crc32c(b"", 0x12345678) == 0x12345678


def test_hash_info_matches_jax_package():
    h, jh = HashInfo(3), jstripe.HashInfo(3)
    a = np.arange(64, dtype=np.uint8)
    b = (np.arange(64, dtype=np.uint8) * 3).astype(np.uint8)
    code = registry.factory("jerasure", {"k": "2", "m": "1"}, device=CPU)
    chunks = code.encode(range(3), _bytes(1000, 3))
    jh.append(0, {0: a, 1: a, 2: a})
    h.append(0, {0: a, 1: torch.from_numpy(a.copy()), 2: a.tobytes()})
    size = chunks[0].numel()
    jh.append(64, {i: chunks[i].numpy() for i in range(3)})
    h.append(64, chunks)
    jh.append(64 + size, {0: b, 1: b, 2: b})
    h.append(64 + size, {0: b, 1: b, 2: b})
    assert h.total_chunk_size == jh.total_chunk_size == 128 + size
    for shard in range(3):
        assert h.get_chunk_hash(shard) == jh.get_chunk_hash(shard)
    whole = crc32c(np.concatenate([a, chunks[0].numpy(), b]))
    assert h.get_chunk_hash(0) == whole
