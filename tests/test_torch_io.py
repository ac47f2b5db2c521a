"""Port parity of the replay's input side, against vins_tpu on the CPU: PNG
decoding (every color type and filter the reference reads), the EuRoC
loaders, the measurement queue and the EuRoC-layout dataset writer."""
import struct
import zlib

import jax
import numpy as np
import pytest

from vins_tpu.io import euroc as jeuroc
from vins_tpu.io import mq as jmq
from vins_tpu.io import png as jpng
from vins_tpu.sim import render as jrender
from vins_tpu.sim.euroc_writer import write_euroc_dataset as jwrite
from vins_tpu_torch import convert
from vins_tpu_torch.io import euroc as teuroc
from vins_tpu_torch.io import mq as tmq
from vins_tpu_torch.io import png as tpng
from vins_tpu_torch.sim import euroc_writer as twriter


# ---------------------------------------------------------------- PNG

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _filter_row(f: int, row: list, prev: list, bpp: int) -> list:
    out = []
    for x, v in enumerate(row):
        a = row[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][f]
        out.append((v - pred) & 0xFF)
    return out


def encode_png(path, data: np.ndarray, ctype: int, depth: int):
    """A PNG of `data` [h, w·bpp] raw bytes, row y filtered with filter type
    y mod 5, the compressed stream split over two IDAT chunks."""
    h = data.shape[0]
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    bpp = ch * depth // 8
    w = data.shape[1] // bpp
    prev = [0] * data.shape[1]
    raw = b""
    for y in range(h):
        row = data[y].tolist()
        raw += bytes([y % 5] + _filter_row(y % 5, row, prev, bpp))
        prev = row
    z = zlib.compress(raw, 9)

    def chunk(typ, body):
        return (struct.pack(">I", len(body)) + typ + body
                + struct.pack(">I", zlib.crc32(typ + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", z[:len(z) // 2]))
        f.write(chunk(b"IDAT", z[len(z) // 2:]))
        f.write(chunk(b"IEND", b""))


FORMATS = {"gray8": (0, 8), "gray16": (0, 16), "gray_alpha": (4, 8), "rgb": (2, 8),
           "rgba": (6, 8)}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_png_decoder_matches_reference(fmt, tmp_path):
    ctype, depth = FORMATS[fmt]
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype] * depth // 8
    rng = np.random.default_rng(7)
    # a smooth ramp plus noise, so the predictors see both
    h, w = 15, 23
    ramp = (np.arange(w * bpp)[None, :] * 3 + np.arange(h)[:, None] * 5) % 256
    data = ((ramp + rng.integers(0, 40, (h, w * bpp))) % 256).astype(np.uint8)
    path = str(tmp_path / f"{fmt}.png")
    encode_png(path, data, ctype, depth)
    out = tpng.read_png_gray(path)
    assert out.dtype == np.uint8 and out.shape == (h, w)
    np.testing.assert_array_equal(out, jpng.read_png_gray(path))
    np.testing.assert_array_equal(out, jpng._read_png_gray_py(path))


def test_png_writer_matches_reference(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (31, 45)).astype(np.uint8)
    tpng.write_png_gray(str(tmp_path / "t.png"), img)
    jpng.write_png_gray(str(tmp_path / "j.png"), img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(tpng.read_png_gray(str(tmp_path / "t.png")), img)


# ------------------------------------------------------------ writer

class JaxRoom:
    """Room.make for the port's writer that builds the JAX writer's room
    (its textures come from jax.random, the port's from numpy)."""

    @staticmethod
    def make(seed, k, device):
        return convert.room(jrender.Room.make(jax.random.PRNGKey(seed), k=k), device=device)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root_t = str(tmp_path_factory.mktemp("torch_tree"))
    root_j = str(tmp_path_factory.mktemp("jax_tree"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twriter, "Room", JaxRoom)
        info_t = twriter.write_euroc_dataset(root_t, duration=0.5, pix_noise=0.0, device="cpu")
    info_j = jwrite(root_j, duration=0.5, pix_noise=0.0)
    return info_t, info_j


def test_writer_csvs_match_reference(trees):
    (info_t, info_j) = trees
    assert {k: v for k, v in info_t.items() if k != "root"} == \
        {k: v for k, v in info_j.items() if k != "root"}
    for rel in ("imu0", "cam0", "state_groundtruth_estimate0"):
        a = open(f"{info_t['root']}/mav0/{rel}/data.csv").read().splitlines()
        b = open(f"{info_j['root']}/mav0/{rel}/data.csv").read().splitlines()
        assert len(a) == len(b) and a[0] == b[0]
        if rel == "cam0":
            assert a == b
            continue
        ra = np.array([[float(x) for x in line.split(",")] for line in a[1:]])
        rb = np.array([[float(x) for x in line.split(",")] for line in b[1:]])
        np.testing.assert_array_equal(ra[:, 0], rb[:, 0])  # integer ns stamps
        np.testing.assert_allclose(ra[:, 1:], rb[:, 1:], rtol=0, atol=1e-9)


def test_writer_frames_match_reference(trees):
    info_t, info_j = trees
    ct = teuroc.load_cam_index(info_t["root"])
    cj = jeuroc.load_cam_index(info_j["root"])
    for pt, pj in zip(ct.paths, cj.paths):
        a = tpng.read_png_gray(pt).astype(int)
        b = jpng.read_png_gray(pj).astype(int)
        # float32 renderers; truncation to 8 bits can split a value that
        # the two put on either side of an integer
        assert np.abs(a - b).max() <= 1
        assert a.std() > 5  # a textured frame


def test_loaders_match_reference(trees):
    root = trees[0]["root"]
    for name in ("load_imu", "load_cam_index", "load_groundtruth"):
        a, b = getattr(teuroc, name)(root), getattr(jeuroc, name)(root)
        assert type(a).__name__ == type(b).__name__ and a._fields == b._fields
        for x, y in zip(a, b):
            if isinstance(x, list):
                assert x == y
            else:
                np.testing.assert_array_equal(x, y)
    imu, cam = teuroc.load_imu(root), teuroc.load_cam_index(root)
    ms_t = list(teuroc.iter_measurements(imu, cam, td=0.0013))
    ms_j = list(jeuroc.iter_measurements(jeuroc.load_imu(root), jeuroc.load_cam_index(root),
                                         td=0.0013))
    assert len(ms_t) == len(ms_j) == len(cam.t)
    for a, b in zip(ms_t, ms_j):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------ queue

def _stream(seed=0, n_imu=300, imu_hz=200.0, img_hz=20.0):
    """Jittered 200 Hz samples; frames between samples (each interval ends
    in a straddling sample); a stale frame, older than every buffered
    sample, pushed after the first frames were consumed."""
    rng = np.random.default_rng(seed)
    t_imu = 0.5 + np.arange(n_imu) / imu_hz + rng.uniform(0, 1e-4, n_imu).cumsum()
    acc = rng.normal(size=(n_imu, 3))
    gyr = rng.normal(size=(n_imu, 3))
    t_img = 0.5 + np.arange(int(n_imu / imu_hz * img_hz)) / img_hz + 0.0137
    return t_imu, acc, gyr, t_img


def _drive(q, td: float):
    t_imu, acc, gyr, t_img = _stream()
    out = []
    half = len(t_imu) // 2
    for k in range(half):
        q.push_imu(t_imu[k], acc[k], gyr[k])
    for i, t in enumerate(t_img[t_img + td < t_imu[half - 1]]):
        q.push_feature(t, payload=i)
    while True:
        try:
            out.append(q.next(td=td, blocking=False))
        except BlockingIOError:
            break
    q.push_feature(0.4, payload=999)  # stale: older than the whole buffer
    for k in range(half, len(t_imu)):
        q.push_imu(t_imu[k], acc[k], gyr[k])
    q.push_imu(t_imu[5], acc[5], gyr[5])  # out of order: rejected
    for i, t in enumerate(t_img):
        if t + td >= t_imu[half - 1]:
            q.push_feature(t, payload=i)
    q.close()
    while (m := q.next(td=td)) is not None:
        out.append(m)
    return out, q.stats()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_measurement_queue_matches_reference(native):
    td = 0.0023
    got, st_t = _drive(tmq.MeasurementQueue(), td)
    ref, st_j = _drive(jmq.MeasurementQueue(native=native), td)
    assert len(got) == len(ref) > 20
    assert 999 not in [m.payload for m in got]
    assert st_t == st_j and st_t["dropped_frames"] == 1 and st_t["rejected_imu"] == 1
    for a, b in zip(got, ref):
        assert (a.t_img, a.payload) == (b.t_img, b.payload)
        assert a.imu_t[-1] == pytest.approx(a.t_img + td, abs=1e-12)
        np.testing.assert_array_equal(a.imu_t, b.imu_t)
        np.testing.assert_allclose(a.imu_acc, b.imu_acc, rtol=0, atol=1e-12)
        np.testing.assert_allclose(a.imu_gyr, b.imu_gyr, rtol=0, atol=1e-12)


def test_measurement_queue_threaded():
    """A producer thread and a blocking consumer give what one thread gives."""
    import threading

    t_imu, acc, gyr, t_img = _stream(seed=1)
    q = tmq.MeasurementQueue()

    def produce():
        ki = 0
        for k in range(len(t_imu)):
            q.push_imu(t_imu[k], acc[k], gyr[k])
            while ki < len(t_img) and t_img[ki] <= t_imu[k]:
                q.push_feature(t_img[ki], payload=ki)
                ki += 1
        q.close()

    th = threading.Thread(target=produce)
    th.start()
    got = []
    while (m := q.next()) is not None:
        got.append(m)
    th.join(timeout=30)
    assert not th.is_alive()
    ref = list(teuroc.iter_measurements(teuroc.ImuData(t_imu, gyr=gyr, acc=acc),
                                        teuroc.CamIndex(t_img, [""] * len(t_img))))
    assert [m.t_img for m in got] == [m.t_img for m in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.imu_t, b.imu_t)
        np.testing.assert_allclose(a.imu_acc, b.imu_acc, rtol=0, atol=1e-12)

