"""The port's serving surfaces — InferenceEngine.evaluate_sample,
evaluate_dataset and export, load_xray_pair, inspect_checkpoint,
psnr_dynamic_range, the phantom disk cache and ``cli infer`` / ``eval`` /
``inspect`` — against the JAX package, with converted weights.

Scaled cascade of tests/test_parity_cascade.py:46-47: 8³→16³→32³ volumes,
64² X-rays, E=32, 4 heads, two stage-1 blocks and one block in each later
stage, fp32 on the CPU (the port's ``--device cpu`` runs the plain versions
of the kernels). ``scaled_cascade`` builds it once a process, for this file
and tests/test_torch_diagnostics.py. The JAX CLI runs on a JAX engine
restored from an Orbax checkpoint of the same variables; the tests hand it
that engine, so its compiled forwards are shared. Metrics and volumes agree
within rtol/atol 2e-4 (the tolerance of tests/test_parity_cascade.py:345);
exports of the same values are equal."""

import gzip
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from PIL import Image

import hybrid_vit_cascade_tpu.inference as jax_inference
from hybrid_vit_cascade_tpu import cli as jax_cli
from hybrid_vit_cascade_tpu.config import Config as JaxConfig
from hybrid_vit_cascade_tpu.data import synthetic as jax_synthetic
from hybrid_vit_cascade_tpu.inference import infer as jax_infer
from hybrid_vit_cascade_tpu.losses.metrics import psnr_dynamic_range as jax_psnr_dynamic
from hybrid_vit_cascade_tpu.training.checkpoint import CheckpointManager as JaxCheckpoints
from hybrid_vit_cascade_tpu.training.trainer import build_model as jax_build_model
from hybrid_vit_cascade_tpu_torch import cli, convert
from hybrid_vit_cascade_tpu_torch.config import Config, data_volume_size
from hybrid_vit_cascade_tpu_torch.data import synthetic
from hybrid_vit_cascade_tpu_torch.data.nifti import read_nifti
from hybrid_vit_cascade_tpu_torch.inference import infer
from hybrid_vit_cascade_tpu_torch.inference.infer import (
    InferenceEngine,
    build_model,
    inspect_checkpoint,
    load_xray_pair,
    save_checkpoint,
    save_npy,
)
from hybrid_vit_cascade_tpu_torch.losses.metrics import psnr_dynamic_range
from hybrid_vit_cascade_tpu_torch.training.checkpoint import CheckpointManager
from tests.test_torch_models import jax_variables

S1, S2, S3 = 8, 16, 32
XR, E, HEADS = 64, 32, 4
DEPTHS = (2, 1, 1)
TOL = dict(rtol=2e-4, atol=2e-4)


def configs(depths=DEPTHS, patients: int = 4):
    """The port's and the JAX package's Config of the scaled cascade, fp32,
    synthetic data."""
    out = []
    for cls in (Config, JaxConfig):
        cfg = cls()
        m = cfg.model
        m.family, m.voxel_dim, m.xray_feature_dim = "cascade", E, E
        m.stage_depths, m.stage_heads, m.stage_sizes = depths, (HEADS,) * 3, (S1, S2, S3)
        m.dtype = "float32"
        cfg.data.xray_size, cfg.data.synthetic, cfg.data.synthetic_patients = XR, True, patients
        out.append(cfg)
    return out


def write_checkpoints(root: Path, seed: int, depths=DEPTHS):
    """The same random variables as a port checkpoint file (convert.cascade)
    and a JAX Orbax entry → (port file, JAX entry, numpy tree)."""
    cfg, jcfg = configs(depths)
    tree, jv = jax_variables(jax_build_model(jcfg), np.random.default_rng(seed),
                             jnp.zeros((1, 2, 1, XR, XR)), max_stage=3)
    model = build_model(cfg)
    model.load_state_dict(convert.cascade(tree), strict=True)
    port = root / "cascade.pt"
    save_checkpoint(port, cfg, model)
    JaxCheckpoints(str(root / "jax")).save(jv, epoch=0, metrics={}, config=jcfg.to_dict())
    return port, root / "jax" / "latest", tree


_SHARED: dict = {}


def scaled_cascade(tmp_path_factory) -> dict:
    """The scaled cascade from seed 11, built once a process: its port
    checkpoint file and JAX Orbax entry, the numpy tree, and an engine of each
    package on them (the JAX one keeps its compiled forwards)."""
    if not _SHARED:
        root = tmp_path_factory.mktemp("cascade")
        port, jax_entry, tree = write_checkpoints(root, seed=11)
        _SHARED.update(port=port, jax_entry=jax_entry, tree=tree,
                       engine=InferenceEngine(port, device="cpu"),
                       jax_engine=jax_inference.InferenceEngine(str(jax_entry)))
    return _SHARED


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg, _ = configs()
    ds = synthetic.SyntheticCTDataset(num_patients=4, volume_size=data_volume_size(cfg),
                                      xray_size=XR)
    return {**scaled_cascade(tmp_path_factory), "ds": ds}


def _close_dicts(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **(tol or TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_psnr_dynamic_range_matches_jax(rng, dtype):
    pred = rng.standard_normal((2, 1, 6, 7, 8)).astype(np.float32)
    target = (0.8 * pred + 0.3 * rng.standard_normal(pred.shape)).astype(np.float32) * 3.0
    jp = jnp.asarray(pred).astype(dtype)
    tp = torch.from_numpy(pred).to(getattr(torch, dtype))
    want = float(jax_psnr_dynamic(jp, jnp.asarray(target)))
    got = float(psnr_dynamic_range(tp, torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("max_stage", [1, 3])
def test_evaluate_sample_matches_jax(setup, max_stage):
    """The cascade branch: stageN_psnr / _ssim / _l1 per stage, each against
    the target resized to the stage, and no psnr_dynamic."""
    item = setup["ds"][1]
    want = setup["jax_engine"].evaluate_sample(item, max_stage=max_stage)
    got = setup["engine"].evaluate_sample(item, max_stage=max_stage)
    assert list(got) == list(want) == [f"stage{s}_{m}" for s in range(1, max_stage + 1)
                                       for m in ("psnr", "ssim", "l1")]
    _close_dicts(got, want)


def test_evaluate_sample_other_family_raises(setup, monkeypatch):
    """Diffusion is the one family the port does not build: evaluate_sample
    refuses it before it reconstructs anything."""
    engine = setup["engine"]
    monkeypatch.setattr(engine.cfg.model, "family", "diffusion")
    monkeypatch.setattr(engine, "reconstruct", None)
    with pytest.raises(NotImplementedError, match="diffusion"):
        engine.evaluate_sample(setup["ds"][2])


def test_evaluate_dataset_matches_jax(setup, tmp_path):
    ds = [setup["ds"][i] for i in (0, 3)]
    want = setup["jax_engine"].evaluate_dataset(ds, out_json=str(tmp_path / "jax.json"))
    got = setup["engine"].evaluate_dataset(ds, out_json=str(tmp_path / "port.json"))
    assert list(got) == list(want)
    for k in want:
        _close_dicts(got[k], want[k])
    jw = json.loads((tmp_path / "jax.json").read_text())
    pw = json.loads((tmp_path / "port.json").read_text())
    assert len(pw["per_sample"]) == len(jw["per_sample"]) == len(ds)
    for g, w in zip(pw["per_sample"], jw["per_sample"]):
        _close_dicts(g, w)
    assert pw["summary"] == got


def _read_nii_gz(path) -> np.ndarray:
    assert gzip.decompress(Path(path).read_bytes())[344:348] == b"n+1\x00"
    return read_nifti(path)


def _same_exports(got: dict, want: dict, tol: dict):
    """The .npy (raw bf16 values: bitwise) and .nii.gz of two export calls
    agree within tol."""
    a, b = np.load(got["npy"]), np.load(want["npy"])
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "V":
        assert a.tobytes() == b.tobytes()
    else:
        np.testing.assert_allclose(a, b, **tol)
    np.testing.assert_allclose(_read_nii_gz(got["nifti"]), _read_nii_gz(want["nifti"]), **tol)


@pytest.mark.parametrize("upscale,denormalize", [(None, False), ((40, 36, 44), True)])
def test_export_matches_jax(setup, tmp_path, monkeypatch, upscale, denormalize):
    """.npy and .nii.gz against the JAX export of the same weights, with the
    upscale (before the denormalisation) and the HU scale. Figures off here
    (the JAX export then raises at its views, after writing both files); the
    CLI tests write them."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    item = setup["ds"][0]
    kw = dict(prefix="p", upscale=upscale, denormalize=denormalize, target=item["ct_volume"][None])
    xr = item["drr_stacked"][None]
    with pytest.raises(ImportError):
        setup["jax_engine"].export(xr, str(tmp_path / "jax"), **kw)
    want = {"npy": str(tmp_path / "jax" / "p.npy"), "nifti": str(tmp_path / "jax" / "p.nii.gz")}
    got = setup["engine"].export(xr, str(tmp_path / "port"), **kw)
    assert list(got) == ["npy", "nifti"]
    assert np.load(got["npy"]).shape == (upscale or (S3,) * 3)
    hu = 200.0 if denormalize else 1.0
    _same_exports(got, want, dict(rtol=2e-4, atol=2e-4 * hu))


def test_export_bf16_volume_matches_jax(setup, tmp_path, monkeypatch):
    """A bf16 output: both engines export the same bf16 volume (each
    reconstruct replaced by it, figures off). Without upscale the .npy files
    are byte-identical (the JAX package's np.save of an ml_dtypes bfloat16
    array) and the NIfTI equal. With upscale (in bf16) and the HU scale
    (fp32): the two resizes' fp32 values differ by up to 2.7e-6 before the
    rounding to bf16, so a value at a rounding tie lands one bf16 ulp apart
    (rtol 2^-7) and one near 0 keeps that difference (atol 1e-3 HU)."""
    vol = np.random.default_rng(3).uniform(-1, 1, (1, 1, S3, S3, S3)).astype(np.float32)
    monkeypatch.setattr(setup["jax_engine"], "reconstruct",
                        lambda xr, **kw: vol.astype(ml_dtypes.bfloat16))
    monkeypatch.setattr(setup["engine"], "reconstruct",
                        lambda xr, **kw: torch.from_numpy(vol).to(torch.bfloat16))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    xr = setup["ds"][0]["drr_stacked"][None]
    for name, kw, tol in (("raw", {}, dict(rtol=0, atol=0)),
                          ("up", dict(upscale=(20, 24, 40), denormalize=True),
                           dict(rtol=2 ** -7, atol=1e-3))):
        jdir = tmp_path / f"jax_{name}"
        with pytest.raises(ImportError):  # the JAX views are outside any try
            setup["jax_engine"].export(xr, str(jdir), **kw)
        want = {"npy": str(jdir / "pred.npy"), "nifti": str(jdir / "pred.nii.gz")}
        got = setup["engine"].export(xr, str(tmp_path / f"port_{name}"), **kw)
        assert list(got) == ["npy", "nifti"]
        if not kw:
            assert Path(got["npy"]).read_bytes() == Path(want["npy"]).read_bytes()
            assert np.load(got["npy"]).dtype == np.dtype("V2")
        else:
            assert np.load(got["npy"]).dtype == np.float32
            assert np.load(got["npy"]).shape == (20, 24, 40)
        _same_exports(got, want, tol)


def test_export_without_matplotlib(setup, tmp_path, monkeypatch, capsys):
    """Without matplotlib both PNG writers print a message and leave their
    keys out; .npy and .nii.gz are still written."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    item = setup["ds"][0]
    paths = setup["engine"].export(item["drr_stacked"][None], str(tmp_path), prefix="q",
                                   target=item["ct_volume"][None])
    assert list(paths) == ["npy", "nifti"]
    out = capsys.readouterr().out
    assert "summary figure skipped" in out and "orthogonal views skipped" in out
    assert not list(tmp_path.glob("*.png"))


def test_save_npy_bf16_bytes_match_numpy(tmp_path):
    """save_npy writes a bf16 tensor as np.save writes the same values as an
    ml_dtypes bfloat16 array, byte for byte; other dtypes through np.save."""
    a = np.linspace(-3, 3, 60, dtype=np.float32).reshape(3, 4, 5)
    np.save(tmp_path / "want.npy", a.astype(ml_dtypes.bfloat16))
    save_npy(tmp_path / "got.npy", torch.from_numpy(a).to(torch.bfloat16))
    assert (tmp_path / "got.npy").read_bytes() == (tmp_path / "want.npy").read_bytes()
    save_npy(tmp_path / "f32.npy", torch.from_numpy(a))
    np.testing.assert_array_equal(np.load(tmp_path / "f32.npy"), a)


@pytest.mark.parametrize("mode,size,rng_range", [("L", 80, (-1.0, 1.0)), ("RGB", 64, (0.0, 1.0)),
                                                 ("L", 48, (0.0, 1.0))])
def test_load_xray_pair_matches_jax(tmp_path, rng, mode, size, rng_range):
    paths = []
    for name in ("pa", "lat"):
        shape = (size, size) if mode == "L" else (size, size, 3)
        p = tmp_path / f"{name}.png"
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8), mode=mode).save(p)
        paths.append(str(p))
    want = jax_infer.load_xray_pair(*paths, size=XR, normalize_range=rng_range)
    got = load_xray_pair(*paths, size=XR, normalize_range=rng_range)
    assert got.shape == want.shape == (1, 2, 1, XR, XR) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_inspect_checkpoint(setup, tmp_path):
    """Names and shapes of a checkpoint file and of a training entry match
    convert.cascade's state dict; an entry's meta.json comes along; a
    missing path reports an error."""
    sd = convert.cascade(setup["tree"])
    want = {k: str(tuple(v.shape)) for k, v in sd.items()}
    report = inspect_checkpoint(setup["port"])
    assert report["arrays"] == want and "error" not in report
    assert list(report["meta"]["config"]["model"]["stage_sizes"]) == [S1, S2, S3]

    cfg, _ = configs()
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save({"state_dict": sd}, epoch=3, metrics={"loss": 1.0}, config=cfg.to_dict())
    entry = inspect_checkpoint(tmp_path / "run" / "latest")
    assert entry["arrays"] == want and entry["meta"]["epoch"] == 3

    missing = inspect_checkpoint(tmp_path / "nowhere")
    assert missing["arrays"] == {} and "error" in missing


def test_phantom_cache_hit_equals_fresh(tmp_path, monkeypatch):
    """With HVC_PHANTOM_CACHE a first item writes the cache file under the
    JAX package's name, and a new dataset reads it back equal to a fresh
    item; below base 64 nothing is cached."""
    kw = dict(num_patients=2, volume_size=(64, 64, 48), xray_size=32)
    fresh = synthetic.SyntheticCTDataset(**kw)[1]
    monkeypatch.setenv("HVC_PHANTOM_CACHE", str(tmp_path))
    first = synthetic.SyntheticCTDataset(**kw)[1]
    files = [p.name for p in tmp_path.iterdir()]
    assert files == ["ph_v2_b64_s1_64x64x48_x32_soft_tissue.npz"]
    hit = synthetic.SyntheticCTDataset(**kw)[1]
    for item in (first, hit):
        for k in ("ct_volume", "drr_stacked"):
            np.testing.assert_array_equal(item[k], fresh[k])
    synthetic.SyntheticCTDataset(num_patients=1, volume_size=(32, 32, 32), xray_size=32)[0]
    assert len(list(tmp_path.iterdir())) == 1


def test_phantom_cache_reads_jax_file(tmp_path, monkeypatch):
    """A cache file the JAX package wrote is read by the port under the same
    name: planted values come back, in the preset's DRR range."""
    monkeypatch.setenv("HVC_PHANTOM_CACHE", str(tmp_path))
    kw = dict(num_patients=1, volume_size=(64, 64, 64), xray_size=16, preset="full", seed=2)
    ds = jax_synthetic.SyntheticCTDataset(**kw)
    path = ds._disk_cache_path(64, 2 * 10007)
    vol = np.full((64, 64, 64), 0.25, np.float32)
    drr = np.full((2, 1, 16, 16), 0.5, np.float32)
    ds._disk_cache_write(path, vol, drr)
    item = synthetic.SyntheticCTDataset(**kw)[0]
    np.testing.assert_array_equal(item["ct_volume"][0], vol)
    np.testing.assert_array_equal(item["drr_stacked"], drr)  # 'full': DRRs in [0, 1]
    assert [p.name for p in tmp_path.iterdir()] == [path.name]


# ------------------------------------------------------------------ the CLI ---


def _run(main, argv, capsys) -> dict:
    main(argv)
    return json.loads(capsys.readouterr().out)


@pytest.fixture
def jax_cli_engine(setup, monkeypatch):
    """The JAX CLI builds its engine from the Orbax entry: hand it the
    fixture's engine (the same restore), whose forwards are compiled."""
    monkeypatch.setattr(jax_inference, "InferenceEngine", lambda path: setup["jax_engine"])


def test_cli_infer_matches_jax(setup, tmp_path, capsys, jax_cli_engine):
    """`infer` on a synthetic dataset item, with upscale and HU scale."""
    args = ["infer", "--synthetic", "--index", "2", "--upscale", "24,24,40", "--denormalize"]
    want = _run(jax_cli.main, args + ["--checkpoint", str(setup["jax_entry"]),
                                      "--output", str(tmp_path / "jax")], capsys)
    got = _run(cli.main, args + ["--checkpoint", str(setup["port"]), "--device", "cpu",
                                 "--output", str(tmp_path / "port")], capsys)
    assert list(got["exports"]) == list(want["exports"]) == ["summary", "npy", "nifti", "views"]
    assert all(Path(got["exports"][k]).is_file() for k in ("summary", "views"))
    assert Path(got["exports"]["npy"]).name == "phantom_0002.npy"
    _close_dicts(got["metrics"], want["metrics"])
    _same_exports(got["exports"], want["exports"], dict(rtol=2e-4, atol=4e-2))


def test_cli_infer_raw_pair_matches_jax(setup, tmp_path, capsys, rng, jax_cli_engine):
    """`infer` on a raw PNG pair: scaled to the checkpoint's normalisation
    preset range ([-1, 1] for soft_tissue), exported as raw_pair.*."""
    pa, lat = tmp_path / "pa.png", tmp_path / "lat.png"
    for p in (pa, lat):
        Image.fromarray((rng.random((80, 80)) * 255).astype(np.uint8)).save(p)
    args = ["infer", "--pa-xray", str(pa), "--lat-xray", str(lat)]
    want = _run(jax_cli.main, args + ["--checkpoint", str(setup["jax_entry"]),
                                      "--output", str(tmp_path / "jax")], capsys)
    got = _run(cli.main, args + ["--checkpoint", str(setup["port"]), "--device", "cpu",
                                 "--output", str(tmp_path / "port")], capsys)
    assert list(got) == ["exports"] and Path(got["exports"]["npy"]).name == "raw_pair.npy"
    assert list(got["exports"]) == list(want["exports"])
    _same_exports(got["exports"], want["exports"], TOL)
    with pytest.raises(SystemExit):
        cli.main(["infer", "--checkpoint", str(setup["port"]), "--device", "cpu",
                  "--pa-xray", str(pa)])


def test_cli_eval_matches_jax(setup, tmp_path, capsys, jax_cli_engine):
    """`eval` on the synthetic test split: the summary it prints and the JSON
    it writes."""
    want = _run(jax_cli.main, ["eval", "--synthetic", "--checkpoint", str(setup["jax_entry"]),
                               "--output", str(tmp_path / "jax.json")], capsys)
    got = _run(cli.main, ["eval", "--synthetic", "--checkpoint", str(setup["port"]),
                          "--device", "cpu", "--output", str(tmp_path / "port.json")], capsys)
    assert list(got) == list(want) and len(got) == 9
    for k in want:
        _close_dicts(got[k], want[k])
    rows = json.loads((tmp_path / "port.json").read_text())["per_sample"]
    want_rows = json.loads((tmp_path / "jax.json").read_text())["per_sample"]
    assert len(rows) == len(want_rows) == 1  # 4 patients: 3 train, 0 val, 1 test
    _close_dicts(rows[0], want_rows[0])


def test_cli_inspect(setup, capsys):
    got = _run(cli.main, ["inspect", "--checkpoint", str(setup["port"])], capsys)
    want = {k: str(tuple(v.shape)) for k, v in convert.cascade(setup["tree"]).items()}
    assert got["arrays"] == want and got["path"] == str(setup["port"])


def test_cli_commands_default_to_cuda(monkeypatch):
    """Every serving command reads --device, whose default is cuda, as the
    engine's."""
    seen = {}
    for cmd in ("infer", "eval", "diagnose"):
        monkeypatch.setattr(cli, f"cmd_{cmd}", lambda args: seen.update({args.cmd: args.device}))
        cli.main([cmd, "--checkpoint", "x"])
    assert seen == {"infer": "cuda", "eval": "cuda", "diagnose": "cuda"}
    assert infer.InferenceEngine.__init__.__defaults__[1] == "cuda"
