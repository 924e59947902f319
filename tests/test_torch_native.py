"""The port's native host data plane (uit_mobile_tpu_torch/native) against
the JAX package's (uit_mobile_tpu/native), bitwise: padded batches of
seeded int16 and float32 clips (ragged lengths, B=1 and B=256), the
multi-hot with out-of-range labels dropped, and the WAV parser on truncated,
lying and fuzzed headers (a bounded set of seeded cases). Then the port's
collate against the JAX collate: native exactly where the JAX rule says,
the same batches, and a failed build that raises, naming the command."""

import struct

import numpy as np
import pytest

from uit_mobile_tpu import native as jax_native
from uit_mobile_tpu.data import hdf5 as jax_hdf5
from uit_mobile_tpu_torch import native
from uit_mobile_tpu_torch.data import hdf5
from uit_mobile_tpu_torch.native import build as native_build


@pytest.fixture(scope="module", autouse=True)
def built():
    from uit_mobile_tpu.native.build import build

    build()
    assert jax_native.available() and native.available()


def _clips(rng, B, dtype, lo=1, hi=4000):
    lengths = rng.integers(lo, hi, B)
    if dtype == "int16":
        return [rng.integers(-32768, 32768, n, dtype=np.int16) for n in lengths]
    return [rng.standard_normal(n).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("B", [1, 7, 256])
def test_pad_batch_equals_jax(dtype, B):
    waves = _clips(np.random.default_rng(B), B, dtype)
    got, lens = native.pad_batch_native(waves, threads=3)
    want, want_lens = jax_native.pad_batch_native(waves, threads=3)
    assert got.dtype == want.dtype == (np.int16 if dtype == "int16" else np.float32)
    assert got.tobytes() == want.tobytes() and got.shape == want.shape
    np.testing.assert_array_equal(lens, want_lens)
    assert lens.dtype == want_lens.dtype == np.int32


def test_pad_batch_refusals_match_jax():
    rng = np.random.default_rng(3)
    for bad in ([rng.standard_normal((2, 10)).astype(np.float32)],
                [np.zeros(4, np.int16), np.zeros(4, np.float32)], []):
        for mod in (native, jax_native):
            with pytest.raises(ValueError):
                mod.pad_batch_native(bad)


def test_multihot_equals_jax():
    rng = np.random.default_rng(4)
    labels = [list(rng.integers(-3, 40, rng.integers(0, 6))) for _ in range(64)]
    labels += [[0, 5], [9], [], [3, 3, 900], [-1, 36]]
    got = native.multihot_batch_native(labels, 37)
    want = jax_native.multihot_batch_native(labels, 37)
    assert got.tobytes() == want.tobytes() and got.shape == (len(labels), 37)


def _wav_blob(n_frames=64, channels=1, bits=16, codec=1, data_len=None, fmt_len=16,
              fmt_first=True, seed=0):
    pcm = np.random.default_rng(seed).integers(-3000, 3000, n_frames * channels,
                                               dtype=np.int16).tobytes()
    body = struct.pack("<HHIIHH", codec, channels, 16000, 16000 * channels * bits // 8,
                       channels * bits // 8, bits)
    body = body.ljust(min(max(fmt_len, 0), 64), b"\0")[:min(max(fmt_len, 0), 64)]
    fmt = b"fmt " + struct.pack("<I", fmt_len & 0xFFFFFFFF) + body
    data = b"data" + struct.pack("<I", (len(pcm) if data_len is None else data_len)
                                 & 0xFFFFFFFF) + pcm
    chunks = fmt + data if fmt_first else data + fmt
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _parse_cases():
    base = _wav_blob()
    cases = [base[:n] for n in range(0, len(base) + 1, 3)]  # truncations
    cases += [_wav_blob(data_len=d) for d in (10_000_000, 0xFFFFFFFF, 0x7FFFFFFF, 1)]
    cases += [_wav_blob(fmt_len=f) for f in (15, 0xFFFFFF00, 0xFFFFFFFF)]
    cases += [_wav_blob(channels=0), _wav_blob(n_frames=0), _wav_blob(channels=2),
              _wav_blob(fmt_first=False), base[:-1], b"", b"RIFF\xff\xff\xff\xffWAVE"]
    cases += [_wav_blob(codec=c) for c in (0, 3, 85)] + [_wav_blob(bits=b) for b in (8, 24)]
    rng = np.random.default_rng(42)
    for i in range(150):  # seeded mutations: byte flips, truncations, splices
        m = bytearray(base)
        if i % 3 == 0:
            for _ in range(int(rng.integers(1, 9))):
                m[int(rng.integers(0, len(m)))] = int(rng.integers(256))
        elif i % 3 == 1:
            m = m[: int(rng.integers(0, len(m)))]
        else:
            at = int(rng.integers(0, len(m)))
            m = m[:at] + bytearray(rng.integers(0, 256, int(rng.integers(1, 64)),
                                                dtype=np.uint8).tobytes()) + m[at:]
        cases.append(bytes(m))
    return cases


def test_wav_parser_equals_jax_on_malformed_and_fuzzed_headers():
    import ctypes

    rcs = set()
    for buf in _parse_cases():
        rc, pcm, ch, sr = native.parse_wav16_native(buf)
        want = jax_native.parse_wav16_native(buf)
        assert (rc, ch, sr) == want[0:1] + want[2:], buf[:48]
        assert (pcm is None) == (want[1] is None)
        if pcm is not None:
            assert pcm.tobytes() == want[1].tobytes()
            lo = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
            assert lo <= pcm.ctypes.data and pcm.ctypes.data + pcm.nbytes <= lo + len(buf)
        rcs.add(rc)
    assert rcs == {0, 1, 2, 3, 4, 5}  # every outcome reached


def test_read_wav_equals_jax(tmp_path):
    from uit_mobile_tpu.data.audio_io import write_wav

    p = tmp_path / "a.wav"
    write_wav(p, np.random.default_rng(5).standard_normal(12345).astype(np.float32) * 0.3)
    for path in (p, "samples/85b877b5_nohash_0.wav"):
        got, sr = native.read_wav_native(path)
        want, want_sr = jax_native.read_wav_native(path)
        assert sr == want_sr and got.tobytes() == want.tobytes() and got.shape == want.shape
    p.write_bytes(_wav_blob(codec=85))
    for mod in (native, jax_native):
        with pytest.raises(Exception):
            mod.read_wav_native(p)


@pytest.mark.parametrize("B, n, spread", [(32, 160_000, 2000), (256, 100_000, 0),
                                          (257, 100_000, 0), (4, 99_999, 0),
                                          (3, 100_000, 1), (1, 100_000, 0), (64, 16_000, 500)])
def test_collate_takes_native_where_jax_does(monkeypatch, B, n, spread):
    """The port's collate and the JAX collate on the same samples: the
    native assembler called in both or in neither, and the same batch."""
    rng = np.random.default_rng(B + n)
    lengths = n + rng.integers(-spread, spread + 1, B) if spread else np.full(B, n)
    if spread == 1:
        lengths = np.array([n - 1, n, n + 1][:B])  # a mean of exactly n
    samples = [(rng.integers(-3000, 3000, int(k), dtype=np.int16),
                np.zeros(5, np.float32), f"c{i}") for i, k in enumerate(lengths)]
    took = {}
    for name, mod in (("port", native), ("jax", jax_native)):
        real = mod.pad_batch_native

        def spy(waves, *a, _real=real, _name=name, **kw):
            took[_name] = True
            return _real(waves, *a, **kw)

        monkeypatch.setattr(mod, "pad_batch_native", spy)
        took[name] = False
    got, want = hdf5.collate(samples), jax_hdf5.collate(samples)
    assert took["port"] == took["jax"] == (B <= 256 and lengths.mean() >= 100_000)
    assert got["wav"].tobytes() == want["wav"].tobytes()
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert got["filenames"] == want["filenames"]


def test_failed_build_raises_naming_the_command(monkeypatch, tmp_path):
    """A broken source on collate's native path raises with the g++
    command; nothing falls back to numpy."""
    bad = tmp_path / "uitdata.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SRC", bad)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    samples = [(np.zeros(120_000, np.int16), np.zeros(2, np.float32), "a")]
    with pytest.raises(RuntimeError, match="g\\+\\+ .*uitdata.cc"):
        hdf5.collate(samples)
    assert not list((tmp_path / "build").glob("*.so"))  # no half-written library
    # the numpy side of the rule is untouched by the broken library
    short = [(np.zeros(1000, np.int16), np.zeros(2, np.float32), "b")]
    assert hdf5.collate(short)["wav"].shape == (1, 1000)


def test_library_is_keyed_on_the_source(monkeypatch, tmp_path):
    src = tmp_path / "uitdata.cc"
    src.write_bytes(native_build.SRC.read_bytes())
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    first = native_build.library_path()
    monkeypatch.setattr(native_build, "SRC", src)
    assert native_build.library_path() == first
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert native_build.library_path() != first
    assert first.parent == tmp_path / "build"
