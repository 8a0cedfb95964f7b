"""The kernel build's name (``ops/native.py::source_digest``): it covers
every source and header in ``csrc/``, so an edited header is rebuilt
rather than a stale library reused. No ``nvcc`` is called."""

import shutil

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import native


def _copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(native.CSRC_DIR, dst)
    return dst


def test_digest_names_the_sources_not_their_directory(tmp_path):
    assert native.source_digest(_copy(tmp_path)) == native.source_digest()


def test_digest_changes_with_a_header(tmp_path):
    csrc = _copy(tmp_path)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc holds no header"
    before = native.source_digest(csrc)
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    assert native.source_digest(csrc) != before


def test_digest_changes_with_a_source(tmp_path):
    csrc = _copy(tmp_path)
    before = native.source_digest(csrc)
    src = csrc / "ps2d_conv3d.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert native.source_digest(csrc) != before
