"""Port vs JAX: the PackedInt pack / unpack kernels' plain versions, and the
psum-safety law over an n = 4 wrap-around word sum.

The JAX side is the Pallas kernels in interpret mode (``kernels.ops``);
words and images must be bit-equal. The JAX unpack cannot take bits = 32
(its field mask overflows int32), so there the port is held to the law.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as kops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.int_compress import clip_limit  # noqa: E402
from repro_torch.parallel.collectives import add_wire_words, psum_wire_words  # noqa: E402

SHAPES = [(7,), (128,), (1000,), (8, 128), (300, 700), (3, 5, 7), (2, 3, 4, 5)]


def _images(shape, bits, n, saturate=False):
    lim = clip_limit(bits, n)
    rng = np.random.default_rng([*shape, bits, n])
    imgs = [rng.integers(-lim, lim + 1, shape).astype(np.int32) for _ in range(n)]
    if saturate:  # all workers at +lim (bit 31 in the top field), then -lim
        for img in imgs:
            flat = img.reshape(-1)
            flat[: flat.size // 2] = lim
            flat[flat.size // 2:] = -lim
    return imgs


def _np_word_sum(words):
    acc = np.zeros_like(words[0])
    for w in words:
        acc = acc + w  # int32 numpy addition wraps mod 2^32
    return acc


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("n", [1, 4])
def test_pack_words_matches_jax(shape, bits, n):
    (img,) = _images(shape, bits, n)[:1]
    want = np.asarray(kops.pack_words(jnp.asarray(img), bits=bits, n_workers=n))
    got = ops.pack_words(torch.from_numpy(img), bits=bits, n_workers=n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.pack_words_ref(torch.from_numpy(img), bits=bits, n_workers=n).numpy(),
        np.asarray(jref.pack_words_ref(jnp.asarray(img), bits=bits, n_workers=n)),
    )


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("n", [1, 4])
def test_unpack_words_matches_jax_and_the_psum_law(shape, bits, n):
    imgs = _images(shape, bits, n, saturate=(n == 4))
    words = [np.asarray(kops.pack_words(jnp.asarray(i), bits=bits, n_workers=n))
             for i in imgs]
    wsum = _np_word_sum(words)
    want = np.asarray(kops.unpack_words(jnp.asarray(wsum), shape, bits=bits, n_summed=n))
    # the port's own wrap-around sum of its own words
    port_sum = psum_wire_words(
        {"w": ops.pack_words(torch.from_numpy(i), bits=bits, n_workers=n)} for i in imgs
    )["w"]
    np.testing.assert_array_equal(port_sum.numpy(), wsum)
    got = ops.unpack_words(port_sum, shape, bits=bits, n_summed=n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.sum(np.stack(imgs), 0, dtype=np.int64))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [1, 4])
def test_unpack_words_bits32_psum_law(shape, n):
    imgs = _images(shape, 32, n, saturate=(n == 4))
    wsum = psum_wire_words(
        {"w": ops.pack_words(torch.from_numpy(i), bits=32, n_workers=n)} for i in imgs
    )["w"]
    got = ops.unpack_words(wsum, shape, bits=32, n_summed=n)
    np.testing.assert_array_equal(got.numpy(), np.sum(np.stack(imgs), 0, dtype=np.int64))


def test_saturated_packed8_sum_sets_bit_31_and_round_trips():
    n, lim = 4, clip_limit(8, 4)
    img = np.full((4000,), lim, np.int32)
    wsum = psum_wire_words(
        {"w": ops.pack_words(torch.from_numpy(img), bits=8, n_workers=n)} for _ in range(n)
    )["w"]
    assert (wsum.numpy() < 0).all()  # the top field's sum 2·n·lim = 248 ≥ 128
    got = ops.unpack_words(wsum, img.shape, bits=8, n_summed=n)
    assert (got.numpy() == n * lim).all()


def test_word_sum_rejects_float_payloads_and_mismatched_leaves():
    with pytest.raises(TypeError, match="integer"):
        add_wire_words(None, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="different leaves"):
        add_wire_words({"a": torch.zeros(3, dtype=torch.int32)},
                       {"b": torch.zeros(3, dtype=torch.int32)})
