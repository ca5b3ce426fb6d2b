"""The VGG/ResNet preprocessing of the port against comic_tpu on the CPU:
the device function preprocess_batch_vgg (eval, and train at comic_tpu's
own flip and crop draws), resize_bilinear_tf1, the dispatch by encoder,
the crop-never-upsample refusal, the host's aspect-preserving modes on
image files (byte-identical uint8 from the same numpy Generator, every
mode and both resize rules), and the pipelines' VGG batches in comic_tpu's
order."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comic_tpu import configuration as jconf
from comic_tpu.data import captions as jcap_io
from comic_tpu.data import pipeline as jpipe
from comic_tpu.data import preprocessing as jprep
from comic_tpu.data.synthetic import make_synthetic_dataset
from comic_tpu.models import encoders as jenc
from comic_tpu_torch import configuration as tconf
from comic_tpu_torch.data import captions as tcap_io
from comic_tpu_torch.data import pipeline as tpipe
from comic_tpu_torch.data import preprocessing as tprep
from comic_tpu_torch.models import encoders as tenc

torch.set_num_threads(1)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def test_vgg_eval_matches():
    images = np.random.default_rng(0).integers(0, 256, (3, 40, 36, 3),
                                               dtype=np.uint8)
    for out_h, out_w in ((24, 20), (40, 36), (31, 17)):
        got = tprep.preprocess_batch_vgg(images, out_h, out_w,
                                         torch.device("cpu"))
        want = jprep.preprocess_batch_vgg(jnp.asarray(images),
                                          jax.random.PRNGKey(0), out_h,
                                          out_w, False)
        assert got.shape == (3, 3, out_h, out_w) and got.dtype == torch.float32
        np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_vgg_train_matches_comic_tpu_draws():
    """The port's crop at the flips and offsets comic_tpu's _augment_one
    draws from its key, minus the means, is comic_tpu's batch exactly; and
    the port's own draws (from a torch.Generator) give a batch of flips and
    crops of the same images."""
    images = np.random.default_rng(3).integers(0, 256, (6, 40, 36, 3),
                                               dtype=np.uint8)
    out_h, out_w = 24, 20
    key = jax.random.PRNGKey(11)
    want = np.asarray(jprep.preprocess_batch_vgg(jnp.asarray(images), key,
                                                 out_h, out_w, True))
    flips, oy, ox = [], [], []
    for k in jax.random.split(key, images.shape[0]):
        k_flip, k_y, k_x = jax.random.split(k, 3)
        flips.append(bool(jax.random.bernoulli(k_flip)))
        oy.append(int(jax.random.randint(k_y, (), 0, 40 - out_h + 1)))
        ox.append(int(jax.random.randint(k_x, (), 0, 36 - out_w + 1)))
    assert any(flips) and not all(flips)
    crop = tprep.augment(torch.from_numpy(images).float(), out_h, out_w,
                         torch.tensor(flips), torch.tensor(oy),
                         torch.tensor(ox))
    got = crop - torch.tensor(tprep.VGG_MEANS_RGB)
    np.testing.assert_array_equal(got.numpy(), want)

    g = torch.Generator().manual_seed(5)
    drawn = _nhwc(tprep.preprocess_batch_vgg(
        images, out_h, out_w, torch.device("cpu"), training=True,
        generator=g)) + np.float32(tprep.VGG_MEANS_RGB)
    g = torch.Generator().manual_seed(5)
    f, y, x = tprep.draw_augment(g, 6, 40, 36, out_h, out_w)
    for i in range(6):
        img = images[i, :, ::-1] if f[i] else images[i]
        np.testing.assert_array_equal(
            drawn[i], img[y[i]: y[i] + out_h, x[i]: x[i] + out_w])


@pytest.mark.parametrize("fn", ["preprocess_batch", "preprocess_batch_vgg"])
def test_crop_never_upsamples(fn):
    images = np.zeros((1, 256, 256, 3), np.uint8)
    with pytest.raises(ValueError, match="never upsamples"):
        getattr(tprep, fn)(images, 299, 299, torch.device("cpu"))
    with pytest.raises(ValueError, match="never upsamples"):
        getattr(jprep, fn)(jnp.asarray(images), jax.random.PRNGKey(0), 299,
                           299, False)


def test_preprocess_for_dispatches_like_comic_tpu():
    for name in jenc.available_encoders():
        vgg = jprep.preprocess_for(name) is jprep.preprocess_batch_vgg
        assert (tprep.preprocess_for(name)
                is (tprep.preprocess_batch_vgg if vgg
                    else tprep.preprocess_batch)), name
        assert vgg == (tenc.get_encoder(name).preprocessing == "vgg")
    assert {n for n in jenc.available_encoders()
            if tprep.preprocess_for(n) is tprep.preprocess_batch_vgg} == {
        "resnet_v1_50", "resnet_v1_101", "resnet_v1_152", "resnet_v2_50",
        "resnet_v2_101", "resnet_v2_152", "vgg_16", "vgg_19"}


@pytest.mark.parametrize("shape,out", [((40, 36, 3), (24, 20)),
                                       ((17, 23, 3), (64, 48)),
                                       ((2, 30, 30, 3), (256, 256))])
def test_resize_bilinear_tf1_matches(shape, out):
    img = np.random.default_rng(4).uniform(0, 255, shape).astype(np.float32)
    got = tprep.resize_bilinear_tf1(torch.from_numpy(img), *out).numpy()
    if img.ndim == 4:
        want = np.stack([np.asarray(jprep.resize_bilinear_tf1(
            jnp.asarray(im), *out)) for im in img])
    else:
        want = np.asarray(jprep.resize_bilinear_tf1(jnp.asarray(img), *out))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 255)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """Seeded PNGs (lossless, so both packages decode the same pixels):
    landscape, portrait, a square, a source smaller than 256 and one whose
    long side truncates below 256 after the aspect resize."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(5)
    paths = []
    for i, (h, w) in enumerate([(300, 400), (480, 200), (256, 256),
                                (120, 90), (237, 511)]):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        path = str(d / f"im{i}.png")
        cv2.imwrite(path, img[:, :, ::-1])
        paths.append(path)
    return paths


@pytest.mark.parametrize("mode", ["square", "aspect_eval", "aspect_train"])
@pytest.mark.parametrize("tf1_exact", [False, True])
def test_host_modes_are_byte_identical(image_files, mode, tf1_exact):
    for i, path in enumerate(image_files):
        got = tprep.load_and_resize_host(path, mode=mode, tf1_exact=tf1_exact,
                                         rng=np.random.default_rng(i))
        want = jprep.load_and_resize_host(path, mode=mode,
                                          tf1_exact=tf1_exact,
                                          rng=np.random.default_rng(i))
        assert got.shape == (256, 256, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_aspect_train_draws_vary_and_pad_tiny_sources(image_files):
    """Two Generators give two crops of one image; the 120x90 source,
    scaled to a side in [256, 512], still comes back 256x256."""
    a, b = (tprep.load_and_resize_host(image_files[0], mode="aspect_train",
                                       rng=np.random.default_rng(s))
            for s in (0, 1))
    assert not np.array_equal(a, b)
    for s in range(4):
        tiny = tprep.load_and_resize_host(image_files[3], mode="aspect_train",
                                          rng=np.random.default_rng(s))
        assert tiny.shape == (256, 256, 3)
    with pytest.raises(ValueError, match="Unknown host resize mode"):
        tprep.load_and_resize_host(image_files[0], mode="crop")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    data, _ = make_synthetic_dataset(root, num_train=16, num_valid=6,
                                     num_test=4, captions_per_image=2,
                                     image_size=300)
    return data


@pytest.mark.parametrize("cnn_name", ["resnet_v1_50", "vgg_19"])
def test_vgg_pipelines_match(synth, cnn_name):
    """TrainPipeline (aspect_train: per-image jitter and crop from the
    config's seed), its eval split (aspect_eval) and ScstPipeline give
    comic_tpu's batches, images byte for byte."""
    base = dict(token_type="radix", radix_base=4, dataset_dir=synth,
                dataset_file_pattern="synth_{}", batch_size_train=4,
                batch_size_eval=3, max_epoch=2, rand_seed=7,
                cnn_name=cnn_name)
    jc, tc = jconf.Config(**base), tconf.Config(**base)
    jv = jcap_io.load_vocab(synth, "synth_{}")
    tv = tcap_io.load_vocab(synth, "synth_{}")
    for split, steps in (("train", 6), ("valid", 2)):
        jp = jpipe.TrainPipeline(jc, jv, split, num_workers=2)
        tp = tpipe.TrainPipeline(tc, tv, split, num_workers=2)
        try:
            jit, tit = ((iter(jp), iter(tp)) if split == "train"
                        else (jp.epoch(), tp.epoch()))
            for _ in range(steps):
                (ji, jcap), (ti, tcap) = next(jit), next(tit)
                np.testing.assert_array_equal(tcap, jcap)
                np.testing.assert_array_equal(ti, ji)
        finally:
            tp.close()
    jp, tp = jpipe.ScstPipeline(jc, jv, num_workers=2), \
        tpipe.ScstPipeline(tc, tv, num_workers=2)
    try:
        for (ji, jrefs), (ti, trefs) in zip(jp.epoch(), tp.epoch()):
            assert trefs == jrefs
            np.testing.assert_array_equal(ti, ji)
    finally:
        tp.close()
