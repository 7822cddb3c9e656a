"""The port's host I/O against the JAX package's: the TIFF codec (reads and
writes both ways, its build from six processes at once, a failed build),
exact percentiles, recordings, the results tree, the merged-label PNGs,
the prefetcher and the upload.

The JAX side runs as the JAX package's own tests run it: through its native
codec when that is built in this process, through PIL otherwise."""

import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import t3dct_torch  # noqa: F401
import t3dct.io.imageio as jio
import t3dct.native.tiff as jtiff
import t3dct.viz as jviz
from t3dct.io.artifacts import ResultsTree as JResultsTree
from t3dct_torch import viz
from t3dct_torch.io import imageio, tiff
from t3dct_torch.io.artifacts import ResultsTree
from t3dct_torch.io.prefetch import VolumePrefetcher, upload_async

REPO = Path(__file__).resolve().parents[1]


def labels(shape, dtype, seed):
    hi = 256 if dtype == np.uint8 else 65536
    return np.random.RandomState(seed).randint(0, hi, shape).astype(dtype)


@pytest.mark.parametrize("lzw", [False, True], ids=["raw", "lzw"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["u8", "u16"])
def test_codec_round_trips_with_jax(tmp_path, dtype, lzw):
    """The port writes (x, y, z) volumes that the JAX reader decodes, and
    decodes what the JAX writer wrote; 8- and 16-bit, raw and LZW."""
    comp = "tiff_lzw" if lzw else None
    vol = labels((37, 29, 3), dtype, seed=int(lzw))
    imageio.save_label_slices(vol, tmp_path / "port", "a_t%03i_z%04i.tif",
                              2, use_8_bit=dtype == np.uint8,
                              compression=comp)
    jio.save_label_slices(vol, tmp_path / "jax", "a_t%03i_z%04i.tif", 2,
                          use_8_bit=dtype == np.uint8, compression=comp)
    for z in range(3):
        name = "a_t002_z%04i.tif" % (z + 1)
        got = jio.imread(str(tmp_path / "port" / name))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, vol[:, :, z])
        mine = imageio.imread(tmp_path / "jax" / name)
        assert mine.dtype == dtype
        np.testing.assert_array_equal(mine, vol[:, :, z])
    stack = imageio.imread_stack(sorted((tmp_path / "jax").glob("*.tif")))
    np.testing.assert_array_equal(stack, vol.transpose(2, 0, 1))


def test_codec_reads_pil_lzw(tmp_path):
    """A PIL-written LZW slice (a microscope's export) decodes exactly."""
    img = labels((50, 61), np.uint16, seed=3)
    Image.fromarray(img).save(tmp_path / "p.tif", compression="tiff_lzw")
    np.testing.assert_array_equal(tiff.tiff_read(tmp_path / "p.tif"), img)
    assert tiff.tiff_info(tmp_path / "p.tif") == (61, 50, 16)


_BUILD = """
import importlib.util, pathlib, sys, time
spec = importlib.util.spec_from_file_location("port_tiff", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
go = pathlib.Path(sys.argv[3])
while not go.exists():
    time.sleep(0.005)
lib = mod.bind(mod.build(pathlib.Path(sys.argv[2])))
print(mod.tiff_read.__name__, lib.t3dct_hist_u16 is not None)
"""


def test_codec_build_is_race_free(tmp_path):
    """Six processes that start the build into one empty directory at the
    same moment all load a complete library: one compiles under the lock,
    the rest wait for it, and nothing half-written is ever loaded."""
    build_dir, go = tmp_path / "build", tmp_path / "go"
    src = REPO / "3deecelltracker_tpu_torch" / "io" / "tiff.py"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(src),
                               str(build_dir), str(go)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    time.sleep(0.5)
    go.touch()
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["tiff_read", "True"]
    assert [f.name for f in build_dir.glob("*.so")] == \
        [tiff.library_path(build_dir).name]


def test_codec_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; nothing falls back."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tiff, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tiff.build(tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_codec_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        imageio.imread(tmp_path / "none.tif")
    with pytest.raises(NotImplementedError):
        imageio.imread(tmp_path / "a.png")


def _u16_cases():
    rng = np.random.RandomState(11)
    return {
        "random": rng.randint(0, 65536, (6, 40, 33)).astype(np.uint16),
        "scene": (rng.rand(8, 64, 48) ** 4 * 50000).astype(np.uint16),
        "constant": np.full((5, 7, 9), 1234, np.uint16),
        "at_65535": np.full((4, 6, 5), 65535, np.uint16),
        "ties_to_65535": np.where(rng.rand(9, 10, 11) < 0.5, 65535,
                                  rng.randint(0, 3, (9, 10, 11))
                                  ).astype(np.uint16),
        "one_voxel": np.array([[[7]]], np.uint16),
    }


@pytest.mark.parametrize("case", list(_u16_cases()))
def test_fast_percentiles_bit_identical(case):
    """Bit for bit ``np.percentile`` and the JAX ``fast_percentiles`` on
    uint16 volumes, at the pipeline's 1/99.8 and across the range."""
    x = _u16_cases()[case]
    qs = (0.0, 1.0, 12.5, 37.5, 50.0, 66.6, 99.8, 100.0)
    got = imageio.fast_percentiles(x, qs)
    assert got.dtype == np.float64
    assert got.tobytes() == np.percentile(x, qs).tobytes()
    assert got.tobytes() == np.asarray(
        jio.fast_percentiles(x, qs)).tobytes()


def test_fast_percentiles_fuzz_and_other_dtypes():
    rng = np.random.RandomState(0)
    for _ in range(500):
        n = rng.randint(1, 40)
        x = rng.randint(0, rng.choice([5, 100, 65536]),
                        size=n).astype(np.uint16)
        q = float(rng.rand() * 100)
        assert imageio.fast_percentiles(x, q)[0] == np.percentile(x, q)
    for x in (rng.randint(0, 256, 999).astype(np.uint8),
              rng.randint(0, 5000, 777).astype(np.int32),
              rng.rand(100).astype(np.float32)):
        assert imageio.fast_percentiles(x, (1.0, 99.8)).tobytes() == \
            np.percentile(x, (1.0, 99.8)).tobytes()
    with pytest.raises(ValueError):
        imageio.fast_percentiles(np.array([3, 7], np.uint16), 100.5)


def test_transport_and_normalize_match_jax():
    x = _u16_cases()["scene"]
    got = imageio.transport_encode(x, "u16")
    want = jio.transport_encode(x, "u16")
    assert got[0] is x and got[1:] == want[1:]
    np.testing.assert_array_equal(imageio.percentile_normalize(x),
                                  jio.percentile_normalize(x))
    with pytest.raises(NotImplementedError, match="A.5b"):
        imageio.transport_encode(x, "u8")
    with pytest.raises(ValueError):
        imageio.transport_encode(x, "f32")


def test_recording_reads_match_jax(tmp_path):
    """``load_2d_slices_at_time`` and ``get_t_range`` on a recording with a
    gap: the same stacks and range as JAX, FileNotFoundError at the gap."""
    rng = np.random.RandomState(4)
    for t in (2, 3, 5):
        vol = rng.randint(0, 60000, (17, 12, 4)).astype(np.uint16)
        imageio.save_label_slices(vol, tmp_path, "raw_t%03i_z%04i.tif", t,
                                  use_8_bit=False, compression=None)
    pattern = str(tmp_path / "raw_t%03i_z*.tif")
    assert imageio.get_t_range(pattern) == jio.get_t_range(pattern) == (5, 2)
    for t in (2, 5):
        for norm in (False, True):
            got = imageio.load_2d_slices_at_time(pattern, t, norm)
            want = jio.load_2d_slices_at_time(pattern, t, norm)
            assert got.dtype == want.dtype and got.shape == (4, 17, 12)
            np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        imageio.load_2d_slices_at_time(pattern, t=4)


def _tree_files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def test_results_tree_same_files_as_jax(tmp_path):
    """The same arrays through both trees: the same file names, dtypes and
    contents; the npy files and the port's TIFFs byte for byte against
    the JAX package's native codec (PIL encodes LZW differently, so
    without it the TIFFs are held to their pixels)."""
    rng = np.random.RandomState(5)
    coords = rng.rand(9, 3).astype(np.float32) * 40
    seg = rng.randint(0, 48, (9, 3)).astype(np.int32)
    prob = rng.rand(24, 32, 6).astype(np.float32)
    lab8 = rng.randint(0, 200, (24, 32, 6)).astype(np.int32)
    lab16 = rng.randint(0, 900, (24, 32, 6)).astype(np.int32)
    for cls, root in ((ResultsTree, tmp_path / "port"),
                      (JResultsTree, tmp_path / "jax")):
        tree = cls(root)
        tree.make_dirs()
        tree.save_seg_coords(3, seg)
        tree.save_seg_prob(3, prob)
        tree.save_coords_real(3, coords)
        tree.save_tracked_labels(lab8, 3, True)
        tree.save_tracked_labels(lab16, 4, False)
    files = _tree_files(tmp_path / "jax")
    assert _tree_files(tmp_path / "port") == files
    assert len(files) == 3 + 12
    native = jtiff.native_available()
    for name in files:
        a, b = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".npy"):
            assert np.load(a).dtype == np.load(b).dtype
            assert a.read_bytes() == b.read_bytes()
        else:
            got, want = imageio.imread(a), jio.imread(str(b))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            if native:
                assert a.read_bytes() == b.read_bytes()
    port = ResultsTree(tmp_path / "port")
    np.testing.assert_array_equal(port.load_seg_coords(3), seg)
    np.testing.assert_array_equal(port.load_coords_real(3), coords)


def test_volume_slices_match_jax(tmp_path):
    """``auto_vol1`` slices: uint8 when the labels fit, else uint16."""
    rng = np.random.RandomState(6)
    for hi in (200, 700):
        vol = rng.randint(0, hi, (20, 15, 3)).astype(np.int32)
        imageio.save_volume_slices(vol, tmp_path / f"p{hi}", "v_z%04i.tif")
        jio.save_volume_slices(vol, tmp_path / f"j{hi}", "v_z%04i.tif")
        for z in range(1, 4):
            got = imageio.imread(tmp_path / f"p{hi}" / ("v_z%04i.tif" % z))
            want = jio.imread(str(tmp_path / f"j{hi}" / ("v_z%04i.tif" % z)))
            assert got.dtype == want.dtype == (np.uint8 if hi < 256
                                               else np.uint16)
            np.testing.assert_array_equal(got, want)


def test_merged_labels_match_jax(tmp_path):
    """The merged-label PNGs decode to the JAX package's pixels: its
    random label colours, the raw max projection, PIL's 50% blend."""
    np.testing.assert_array_equal(viz.LABEL_COLORS, jviz.lbl_cmap.colors)
    rng = np.random.RandomState(7)
    raw = rng.randint(0, 50000, (30, 22, 5)).astype(np.uint16)
    imageio.save_label_slices(raw, tmp_path / "raw", "raw_t%03i_z%04i.tif",
                              1, use_8_bit=False, compression=None)
    pattern = str(tmp_path / "raw" / "raw_t%03i_z*.tif")
    lab = rng.randint(0, 300, (30, 22, 5)).astype(np.int32)
    viz.save_merged_labels(tmp_path / "port", lab, pattern, 1, 10)
    jviz.save_merged_labels(JResultsTree(tmp_path / "jax"), lab, pattern, 1,
                            10)
    for sub in ("merged_labels/merged_labels_t000001.png",
                "merged_labels_xz/merged_labels_xz_t000001.png"):
        got = np.asarray(Image.open(tmp_path / "port/track_results" / sub))
        want = np.asarray(Image.open(tmp_path / "jax/track_results" / sub))
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("workers", [1, 2])
def test_prefetcher_order_and_errors(workers):
    """Volumes arrive in t order; a failed load surfaces, in order, after
    the volumes before it; ``close`` stops the workers."""
    def load(t):
        if t == 5:
            raise FileNotFoundError(f"No image at time {t} was found")
        time.sleep(0.01 * (t % 2))
        return np.full(3, t)

    pf = VolumePrefetcher(load, range(1, 8), depth=2, workers=workers)
    seen = []
    with pytest.raises(FileNotFoundError):
        for t, v in pf:
            assert (v == t).all()
            seen.append(t)
    assert seen == [1, 2, 3, 4]
    pf.close()
    assert list(pf) == []
    pf2 = VolumePrefetcher(lambda t: t, range(3), workers=workers)
    assert [v for _, v in pf2] == [0, 1, 2]
    pf2.close()
    assert not pf2._thread.is_alive()


def test_upload_widens_uint16_exactly():
    """uint16 travels as int16 bits and widens on the device, exactly (on
    the CPU, a plain copy with no stream or event)."""
    x = np.array([[0, 1, 32767, 32768, 65535]], np.uint16)
    up = upload_async(x, torch.device("cpu"), None)
    assert up.event is None
    got = up.wait()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int32))
    f = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    np.testing.assert_array_equal(
        upload_async(f, torch.device("cpu"), None).wait().numpy(), f)


def test_codec_module_loads_alone():
    """``io/tiff.py`` imports numpy and the standard library only, so a
    bare process (the build test above) can load it."""
    spec = importlib.util.spec_from_file_location(
        "bare_tiff", REPO / "3deecelltracker_tpu_torch" / "io" / "tiff.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.library_path() == tiff.library_path()


def test_port_imports_no_pil_or_matplotlib():
    """The card's machine has neither: a fresh import of every port module
    that this path uses, the codec and the PNG writer included, leaves
    both out (and JAX, as ``test_import_hygiene_no_jax`` checks)."""
    code = ("import sys; sys.path.insert(0, %r); import t3dct_torch; "
            "import t3dct_torch.engine.pipeline, t3dct_torch.viz; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'matplotlib', 'jax')); print(bad); "
            "sys.exit(1 if bad else 0)" % str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _eoi_width_cases():
    """Label slices whose LZW table ends one entry short of a code-width
    change: the encoder (the JAX package's source too) then writes EOI at
    the old width, and the padding after it reads as a valid code at the
    new one.  A small seeded slice, and slice 9 of volume 8 of JAX's
    ensemble record, where the port first met it."""
    rng = np.random.RandomState(987)
    w, h = rng.randint(20, 70), rng.randint(20, 70)
    small = ((rng.rand(h, w) < 0.3) * rng.randint(1, 5, (h, w))
             ).astype(np.uint8)
    with np.load(REPO / "3deecelltracker_tpu_torch" / "assets" / "bench" /
                 "jax_record_ensemble.npz") as rec:
        bench = np.ascontiguousarray(rec["labels_8"][:, :, 8])
    return {"small": small, "bench": bench}


@pytest.mark.parametrize("case", ["small", "bench"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_codec_reads_lzw_with_early_eoi(tmp_path, case, writer):
    """The decoder stops once the strip is full, as libtiff's does, so it
    reads these slices, written by the port or by the JAX package, as PIL
    reads them."""
    img = _eoi_width_cases()[case]
    vol = img[:, :, None]
    save = imageio.save_label_slices if writer == "port" else \
        jio.save_label_slices
    save(vol, tmp_path, "s_t%06i_z%04i.tif", 1, True)
    path = tmp_path / "s_t000001_z0001.tif"
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(imageio.imread_stack([path, path])[1],
                                  img)
