"""The port's dataset preparation (uit_mobile_tpu_torch.data.prep and
cli/prep.py) against the JAX package's on synthetic wav trees, built as
tests/test_prep.py builds them: the same TSV bytes, HDF5 stores equal key
for key and bit for bit, and the .npz store holding the same keys and PCM;
the .npz route with h5py and pandas blocked."""

import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pandas as pd

from uit_mobile_tpu.data.audio_io import write_wav
from uit_mobile_tpu.data.prep import LABEL_MAPS_GSC_AUDIOSET as JAX_LABEL_MAPS
from uit_mobile_tpu.data.prep import build_audioset_manifest as jax_build_audioset_manifest
from uit_mobile_tpu.data.prep import dump_waves as jax_dump_waves
from uit_mobile_tpu.data.prep import prepare_gsc as jax_prepare_gsc
from uit_mobile_tpu_torch.cli import prep as prep_cli
from uit_mobile_tpu_torch.data import WeakHDF5Dataset, read_tsv_data
from uit_mobile_tpu_torch.data.prep import (LABEL_MAPS_GSC_AUDIOSET, dump_waves, prepare_gsc,
                                            wav_duration_seconds)

REPO = Path(__file__).resolve().parent.parent


def _gsc_tree(root: Path, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    for w in ("on", "off", "bed", "cat"):
        for i in range(3):
            write_wav(root / w / f"clip{i}.wav",
                      rng.standard_normal(16000).astype(np.float32) * 0.1)
    write_wav(root / "_background_noise_" / "noise.wav",
              rng.standard_normal(16000).astype(np.float32) * 0.1)
    (root / "validation_list.txt").write_text("on/clip1.wav\nbed/clip1.wav\n")
    (root / "testing_list.txt").write_text("on/clip2.wav\ncat/clip2.wav\n")


def _h5_arrays(path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__("/" + k, v[...])
                     if isinstance(v, h5py.Dataset) else None)
    return out


def _npz_arrays(path) -> dict:
    with np.load(path) as z:
        return {("" if k.startswith("/") else "/") + k: z[k] for k in z.files}


def _same_arrays(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a)


def test_label_map_equals_jax():
    assert LABEL_MAPS_GSC_AUDIOSET == JAX_LABEL_MAPS


def test_prepare_gsc_equals_jax(tmp_path):
    raw = tmp_path / "raw"
    _gsc_tree(raw)
    out = tmp_path / "data"
    want = jax_prepare_gsc(raw, out)
    want_tsv = {k: Path(v).read_bytes() for k, v in want.items()}
    want_h5 = {k: _h5_arrays(out / "hdf5" / f"{k}.h5") for k in want}
    got = prepare_gsc(raw, out)
    assert list(got) == list(want) == ["train", "valid", "test"]
    for k in want:
        assert Path(got[k]).read_bytes() == want_tsv[k], k
        assert _same_arrays(_h5_arrays(out / "hdf5" / f"{k}.h5"), want_h5[k]), k
    assert sum(len(v) for v in want_h5.values()) == 12  # the noise folder left out
    # the .npz store: same manifests but for the store's name, same keys and PCM
    npz = prepare_gsc(raw, tmp_path / "npz", store="npz")
    for k in want:
        rows = Path(npz[k]).read_text().replace(str(tmp_path / "npz" / "hdf5"), "").replace(
            ".npz", ".h5")
        assert rows == want_tsv[k].decode().replace(str(out / "hdf5"), ""), k
        assert _same_arrays(_npz_arrays(tmp_path / "npz" / "hdf5" / f"{k}.npz"), want_h5[k]), k
    # the port's dataset reads a prepared split as the JAX package wrote it
    ds = WeakHDF5Dataset(read_tsv_data(npz["test"], basename=False), num_classes=537)
    for i in range(len(ds)):
        wav, target, fname = ds[i]
        np.testing.assert_array_equal(wav, want_h5["test"][fname] / np.float32(32768.0))
        assert target[532 if "/on/" in fname else 0] == target.sum() == 1.0
        assert wav_duration_seconds(fname) == 1.0


def test_audioset_manifest_cli_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    root = tmp_path / "audio"
    write_wav(root / "ytid1_0.000_10.000.wav", rng.standard_normal(16000) * 0.1)
    write_wav(root / "ytid2_5.000_15.000.wav", rng.standard_normal(32000) * 0.1)
    write_wav(root / "ytid5_1.000_11.000.wav", rng.standard_normal(800) * 0.1)  # 0.05 s: short
    (root / "ytid4_0.000_10.000.wav").write_bytes(b"")
    (root / "ytid6_0.000_10.000.wav").write_bytes(b"RIFF0000WAVE")  # corrupt
    seg = tmp_path / "segments.csv"
    seg.write_text(
        "# header\n# header\n# header\n"
        'ytid1, 0.000, 10.000, "/m/09x0r"\n'
        'ytid2, 5.000, 15.000, "/m/09x0r,/m/05zppz"\n'
        'ytid3, 0.000, 10.000, "/m/09x0r"\n'
        'ytid4, 0.000, 10.000, "/m/09x0r"\n'
        'ytid5, 1.000, 11.000, "/m/05zppz"\n'
        'ytid6, 0.000, 10.000, "/m/05zppz"\n')
    cli = tmp_path / "class_labels_indices.csv"
    cli.write_text('index,mid,display_name\n0,/m/09x0r,"Speech"\n1,/m/05zppz,"Male speech, man"\n')
    want = tmp_path / "jax.tsv"
    df = jax_build_audioset_manifest(root, seg, cli)
    df.to_csv(want, sep="\t", index=False)  # as datasets/utils/prepare_label_list.py writes it
    got = tmp_path / "port.tsv"
    assert prep_cli.main(["audioset-manifest", str(root), str(seg), str(cli), str(got)]) == 0
    assert len(df) == 2 and got.read_bytes() == want.read_bytes()


def _wavs(tmp_path, n=3):
    rng = np.random.default_rng(2)
    paths = []
    for i in range(n):
        p = tmp_path / f"w{i}.wav"
        write_wav(p, rng.standard_normal(8000).astype(np.float32) * 0.2)
        paths.append(str(p))
    # a second file with w0's basename: warned about and skipped under basename keys
    write_wav(tmp_path / "sub" / "w0.wav", rng.standard_normal(4000).astype(np.float32) * 0.2)
    return paths + [str(tmp_path / "sub" / "w0.wav")]


def test_dump_waves_equals_jax(tmp_path, capsys):
    paths = _wavs(tmp_path)
    for fullname in (False, True):
        jax_dump_waves(pd.DataFrame({"filename": paths + paths[:1]}), tmp_path / "jax.h5",
                       use_fullname=fullname, progress=False)
        want = _h5_arrays(tmp_path / "jax.h5")
        assert len(want) == (4 if fullname else 3)
        dump_waves(paths + paths[:1], tmp_path / "port.h5", use_fullname=fullname,
                   progress=False)
        assert _same_arrays(_h5_arrays(tmp_path / "port.h5"), want)
        dump_waves(pd.DataFrame({"filename": paths}), tmp_path / "port.npz",
                   use_fullname=fullname, progress=False)
        assert _same_arrays(_npz_arrays(tmp_path / "port.npz"), want)
    assert "already exists" in capsys.readouterr().out


def test_npz_route_without_h5py_or_pandas(tmp_path):
    """dump_waves, cli.prep dump and cli.prep gsc --store npz with h5py and
    pandas blocked, each store equal to the JAX package's HDF5."""
    paths = _wavs(tmp_path)
    manifest = tmp_path / "in.tsv"
    manifest.write_text("filename\tlabels\n" + "".join(f"{p}\t0\n" for p in paths))
    raw = tmp_path / "raw"
    _gsc_tree(raw)
    code = (
        "import sys\n"
        "for name in ('h5py', 'pandas', 'jax', 'uit_mobile_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from uit_mobile_tpu_torch.cli import prep as cli\n"
        "from uit_mobile_tpu_torch.data.prep import dump_waves\n"
        f"dump_waves({paths!r}, {str(tmp_path / 'a.npz')!r}, progress=False)\n"
        f"assert cli.main(['dump', {str(manifest)!r}, '-o', {str(tmp_path / 'b.npz')!r},"
        " '-u']) == 0\n"
        f"assert cli.main(['gsc', {str(raw)!r}, {str(tmp_path / 'gsc')!r}, '--store',"
        " 'npz']) == 0\n"
        "assert not {'h5py', 'pandas'} & {k for k, v in sys.modules.items() if v is not None}\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    for fullname, npz in ((False, "a.npz"), (True, "b.npz")):
        jax_dump_waves(pd.DataFrame({"filename": paths}), tmp_path / "jax.h5",
                       use_fullname=fullname, progress=False)
        assert _same_arrays(_npz_arrays(tmp_path / npz), _h5_arrays(tmp_path / "jax.h5"))
    jax_prepare_gsc(raw, tmp_path / "jax_gsc")
    for k in ("train", "valid", "test"):
        assert _same_arrays(_npz_arrays(tmp_path / "gsc" / "hdf5" / f"{k}.npz"),
                            _h5_arrays(tmp_path / "jax_gsc" / "hdf5" / f"{k}.h5")), k
