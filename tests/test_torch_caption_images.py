"""The port's directory captioner
(``python -m simpleimagecaptionzoo_tpu_torch.tools.caption_images``) on the
CPU, driven as tests/test_caption_tool.py drives the JAX package's tool:
a directory of JPEGs and one corrupt file, a checkpoint written by the JAX
package (tests/torch_serving.py), ``--gpu_id cpu``.  The corrupt file is
reported and left out; every other image's caption equals the JAX
package's bundle decode of the same pixels in the same chunks (the last
padded by repeating its last image), float32 trunks on both sides."""
import json
import os

import numpy as np
import pytest
import torch

import torch_serving as TSV
from simpleimagecaptionzoo_tpu.data.datasets import \
    load_image_uint8 as jax_load_image
from simpleimagecaptionzoo_tpu_torch.tools import caption_images

N_PHOTOS, BATCH = 5, 4


@pytest.fixture(scope="module", autouse=True)
def shallow():
    with TSV.shallow_f32_trunks():
        yield


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _photo_dir(root):
    img_dir = os.path.join(str(root), "photos")
    os.makedirs(img_dir)
    from PIL import Image
    sides = (160, 224, 300, 200, 256)
    for i, side in enumerate(sides[:N_PHOTOS]):
        Image.fromarray(TSV.photos(1, side, 30 + i)[0]).save(
            os.path.join(img_dir, "photo_%d.jpg" % i), quality=90)
    # one corrupt file must be skipped with a warning, not abort the run
    with open(os.path.join(img_dir, "corrupt.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 not a jpeg")
    return img_dir


@pytest.mark.parametrize("family,beam", [("NIC", -1), ("BUTDSpatial", 3)])
def test_directory_captions_equal_jax_bundle(family, beam, tmp_path, capsys,
                                            monkeypatch):
    layout = TSV.write_layout(tmp_path, family)
    img_dir = _photo_dir(tmp_path)
    out = tmp_path / "caps.json"
    argv = ["--image_dir", img_dir] + TSV.flags(layout) + [
        "--beam", str(beam), "--batch", str(BATCH), "--dtype", "float32",
        "--out", str(out), "--gpu_id", "cpu"]
    monkeypatch.chdir(tmp_path)
    assert caption_images.main(argv) == 0
    err = capsys.readouterr().err
    assert "skipping unreadable image 'corrupt.jpg'" in err
    with open(out) as f:
        results = json.load(f)
    names = ["photo_%d.jpg" % i for i in range(N_PHOTOS)]
    assert [r["file_name"] for r in results] == names   # corrupt excluded

    # the JAX bundle on the same pixels, in the tool's chunks: the corrupt
    # file sorts first and is black in the first chunk
    jb = TSV.jax_bundle(layout, beam, "float32")
    order = sorted(["corrupt.jpg"] + names)
    imgs = [np.zeros((224, 224, 3), np.uint8) if n == "corrupt.jpg"
            else jax_load_image(os.path.join(img_dir, n), 224) for n in order]
    want = {}
    for i in range(0, len(order), BATCH):
        chunk, pix = order[i:i + BATCH], imgs[i:i + BATCH]
        pix = pix + [pix[-1]] * (BATCH - len(pix))
        want.update(zip(chunk, TSV.jax_captions(jb, np.stack(pix))))
    got = {r["file_name"]: r["caption"] for r in results}
    assert got == {n: want[n] for n in names}
    assert len(set(got.values())) >= 2, got


def test_invalid_beam_exits_with_jax_message(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    layout = TSV.write_layout(tmp_path, "NIC")
    img_dir = _photo_dir(tmp_path)
    argv = ["--image_dir", img_dir] + TSV.flags(layout) + [
        "--beam", "0", "--batch", str(BATCH), "--dtype", "float32",
        "--out", str(tmp_path / "caps.json"), "--gpu_id", "cpu"]
    with pytest.raises(SystemExit, match="--beam"):
        caption_images.main(argv)


def test_tool_defaults_to_the_gpu(tmp_path, monkeypatch):
    """Without ``--gpu_id cpu`` the tool runs on cuda:0, and raises without
    a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    layout = TSV.write_layout(tmp_path, "NIC")
    img_dir = _photo_dir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        caption_images.main(["--image_dir", img_dir] + TSV.flags(layout)
                            + ["--out", str(tmp_path / "caps.json")])
