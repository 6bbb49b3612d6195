"""synapseml_torch.image against the JAX package's image module.

Every stage runs on the inputs of tests/test_image.py (random uint8-valued
float images, ragged and rectangular, over two partitions) in both
packages; the outputs are bitwise equal, with the same shapes, dtypes and
column layouts (a stacked tensor column or an object column of ragged
images). The stages are numpy on the host in both packages.
"""

import io

import numpy as np
import pytest

import synapseml_torch as pt
from synapseml_torch import image as timage
from synapseml_torch.image.transforms import bilinear_resize as tresize
from synapseml_torch.image.unroll import decode_image_bytes
from synapseml_tpu import image as jimage
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.image.transforms import bilinear_resize as jresize
from synapseml_tpu.io.files import decode_image_bytes as jdecode


def _images(n=4, h=24, w=32, c=3, seed=0, ragged=False):
    rs = np.random.default_rng(seed)
    return [rs.integers(0, 256, size=(h + (i * 4 if ragged else 0), w, c)).astype(np.float32)
            for i in range(n)]


def _frames(data: dict, num_partitions=2):
    return (pt.DataFrame.from_dict(data, num_partitions=num_partitions),
            JDataFrame.from_dict(data, num_partitions=num_partitions))


def _assert_bitwise(ours, theirs):
    assert len(ours.partitions) == len(theirs.partitions)
    for p, q in zip(ours.partitions, theirs.partitions):
        assert list(p) == list(q)
        for col in p:
            a, b = p[col], q[col]
            assert a.dtype == b.dtype and a.shape == b.shape, col
            if a.dtype == object:
                for x, y in zip(a, b):
                    x, y = np.asarray(x), np.asarray(y)
                    assert x.dtype == y.dtype and x.shape == y.shape, col
                    assert np.array_equal(x, y), col
            else:
                assert np.array_equal(a, b), col


def _pipeline(mod, steps):
    it = mod.ImageTransformer(input_col="image", output_col="out")
    for name, kw in steps:
        it = getattr(it, name)(**kw)
    return it


_PIPELINES = {
    "resize, center crop, normalize (ragged)": (
        [("resize", dict(size=20, keep_aspect_ratio=True)), ("center_crop", dict(height=16, width=16)),
         ("normalize", dict(means=[0.485, 0.456, 0.406], stds=[0.229, 0.224, 0.225],
                            color_scale_factor=1 / 255.0))], True),
    "resize to a box": ([("resize", dict(height=13, width=9))], False),
    "crop": ([("crop", dict(x=3, y=2, height=10, width=12))], False),
    "gray, threshold, flip": ([("color_format", dict(format="gray")),
                               ("threshold", dict(threshold=127, max_val=255)),
                               ("flip", dict(flip_code=1))], False),
    "flip, gray, threshold": ([("flip", dict(flip_code=1)), ("color_format", dict(format="gray")),
                               ("threshold", dict(threshold=127, max_val=255))], False),
    "bgr, vertical and double flips": ([("color_format", dict(format="bgr")),
                                        ("flip", dict(flip_code=0)),
                                        ("flip", dict(flip_code=-1))], True),
    "gaussian blur": ([("gaussian_blur", dict(sigma=2.0))], False),
    "blur with an aperture": ([("gaussian_blur", dict(aperture_size=5, sigma=1.5))], True),
}


@pytest.mark.parametrize("case", sorted(_PIPELINES))
def test_image_transformer_matches_jax(case):
    steps, ragged = _PIPELINES[case]
    ours_df, theirs_df = _frames({"image": _images(ragged=ragged), "label": np.arange(4)})
    _assert_bitwise(_pipeline(timage, steps).transform(ours_df),
                    _pipeline(jimage, steps).transform(theirs_df))


def test_bilinear_resize_matches_jax():
    img = _images(1, 11, 7)[0]
    for h, w in ((11, 7), (22, 14), (5, 3), (16, 16)):
        assert np.array_equal(tresize(img, h, w), jresize(img, h, w))


@pytest.mark.parametrize("lr,ud", [(True, True), (True, False), (False, True)])
def test_augmenter_matches_jax(lr, ud):
    ours_df, theirs_df = _frames({"image": _images(3), "label": np.arange(3)})
    kw = dict(input_col="image", output_col="image", flip_left_right=lr, flip_up_down=ud)
    ours = timage.ImageSetAugmenter(**kw).transform(ours_df)
    _assert_bitwise(ours, jimage.ImageSetAugmenter(**kw).transform(theirs_df))
    assert ours.count() == 3 * (1 + lr + ud)


@pytest.mark.parametrize("ragged", [False, True])
def test_unroll_matches_jax(ragged):
    ours_df, theirs_df = _frames({"image": _images(3, 8, 8, ragged=ragged)})
    kw = dict(input_col="image", output_col="vec")
    _assert_bitwise(timage.UnrollImage(**kw).transform(ours_df),
                    jimage.UnrollImage(**kw).transform(theirs_df))


def test_unroll_binary_image_matches_jax():
    from PIL import Image

    buf = io.BytesIO()
    arr = np.arange(27, dtype=np.uint8).reshape(3, 3, 3)
    Image.fromarray(arr).save(buf, format="PNG")
    gray = io.BytesIO()
    Image.fromarray(arr[..., 0]).save(gray, format="PNG")
    rows = [{"content": buf.getvalue()}, {"content": b"not-an-image"},
            {"content": gray.getvalue()}]
    ours = timage.UnrollBinaryImage().transform(pt.DataFrame.from_rows(rows))
    theirs = jimage.UnrollBinaryImage().transform(JDataFrame.from_rows(rows))
    _assert_bitwise(ours, theirs)
    vecs = ours.collect_column("unrolled")
    assert np.array_equal(vecs[0], arr.ravel()) and len(vecs[1]) == 0
    for raw in (buf.getvalue(), gray.getvalue()):
        assert np.array_equal(decode_image_bytes(raw), jdecode(raw))


def test_superpixels_match_jax():
    img = np.zeros((32, 32, 3), np.float32)
    img[:, 16:] = 255.0
    noisy = _images(1, 24, 20)[0]
    for x, cell in ((img, 8.0), (noisy, 6.0)):
        assert np.array_equal(timage.slic_segments(x, cell_size=cell),
                              jimage.slic_segments(x, cell_size=cell))
    ours_df, theirs_df = _frames({"image": [img, noisy]})
    _assert_bitwise(timage.SuperpixelTransformer(cell_size=8.0).transform(ours_df),
                    jimage.SuperpixelTransformer(cell_size=8.0).transform(theirs_df))


def test_params_match_the_jax_stages():
    for name in ("ImageTransformer", "ImageSetAugmenter", "UnrollImage", "UnrollBinaryImage",
                 "SuperpixelTransformer"):
        ours = {k: v.default for k, v in getattr(timage, name).params().items()}
        theirs = {k: v.default for k, v in getattr(jimage, name).params().items()}
        assert ours == theirs, name
    assert sorted(timage.__all__) == sorted(jimage.__all__)


def test_save_load_round_trip(tmp_path):
    df = _frames({"image": _images(ragged=True)})[0]
    it = _pipeline(timage, _PIPELINES["resize, center crop, normalize (ragged)"][0])
    want = it.transform(df)
    it.save(str(tmp_path / "it"))
    got = pt.load_stage(str(tmp_path / "it")).transform(df)
    _assert_bitwise(got, want)


def test_missing_column_errors():
    df = _frames({"image": _images()})[0]
    with pytest.raises(ValueError, match="input column"):
        timage.ImageTransformer(input_col="nope").transform(df)
