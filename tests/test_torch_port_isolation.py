"""The port stands alone: importing every module of
``mdeical_image_segmentation_tpu_torch`` pulls in none of jax, flax, optax,
msgpack, PIL, h5py, yaml, sklearn, matplotlib, imageio, tifffile, skimage,
orbax, tensorstore, zstandard, zarr or numcodecs (the machine with the card
has none of them),
and its kernels are built for Hopper (sm_90a) by nvcc at first use, never at
import."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import mdeical_image_segmentation_tpu_torch as port
from mdeical_image_segmentation_tpu_torch.ops import _build, fused_conv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "msgpack", "PIL", "h5py", "yaml",
             "sklearn", "matplotlib", "imageio", "tifffile", "skimage",
             "orbax", "tensorstore", "zstandard", "zarr", "numcodecs")


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax_flax_msgpack_pil():
    modules = _port_modules()
    # 89 with data parallelism (parallel/, train/dist_ckpt.py), the
    # profiler tooling, viz, spatial sharding, tensor parallelism, ZeRO-1
    # and the TIFF, GIF and BMP readers; the newer modules are named so a
    # rename cannot drop them from the walk unseen
    assert len(modules) >= 89
    for name in ("ops.initializers", "ops.batchnorm", "ops.msssim",
                 "ops.remat", "ops.image", "models.unet2d",
                 "utils.yaml_io", "utils.hdf5", "configs.config",
                 "transforms.volume", "transforms.skimage_compat",
                 "data.hdf5", "cli.train3d", "cli.predict3d",
                 "models.se3d", "data.device_cache", "ops.quant",
                 "export", "cli.export", "models.sam", "models.wrappers3d",
                 "data.dsb", "metrics.seg_compat", "metrics.seg_metrics",
                 "metrics.surface", "infer.predictor", "train.optimizers",
                 "parallel", "parallel.distributed", "parallel.mesh",
                 "parallel.spatial", "parallel.tensor", "parallel.zero",
                 "train.dist_ckpt", "train.profiling", "utils.viz",
                 "utils.image", "utils.image_base", "utils.tiff",
                 "utils.gif", "utils.bmp", "utils.zstd", "utils.ocdbt",
                 "utils.zarr2", "train.orbax_ckpt"):
        assert f"{port.__name__}.{name}" in modules, name
    code = (
        "import importlib, sys\n"
        # torch.distributed.checkpoint imports zstandard itself where it is
        # installed (an optional codec of its own, absent on the card's
        # machine): the port may add none; the guarded test below shows
        # that it needs none
        "import torch.distributed.checkpoint\n"
        f"torch_own = {{m for m in {FORBIDDEN!r} if m in sys.modules}}\n"
        "assert torch_own <= {'zstandard'}, torch_own\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules\n"
        "       and m not in torch_own]\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
        "from mdeical_image_segmentation_tpu_torch.ops import _build\n"
        "assert _build._lib is None and not _build._host_libs  # no build\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok")


def test_3d_clis_run_without_h5py_and_yaml(tmp_path):
    """In a process where importing h5py, yaml, imageio, PIL, tifffile,
    skimage, orbax, tensorstore or zstandard fails (as on the card's
    machine), both CLIs' modules import, read the yml configs and an HDF5
    file the port writes and appends to, the image reader opens a TIFF, a
    GIF and a BMP, the JAX trainer's orbax checkpoint is read, and the DSB
    reader, the surface metrics and the Lazy and DSB predictors import."""
    code = (
        "import builtins, sys\n"
        "real = builtins.__import__\n"
        "def guarded(name, *a, **k):\n"
        f"    if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "        raise ImportError(f'no {name} here')\n"
        "    return real(name, *a, **k)\n"
        "builtins.__import__ = guarded\n"
        "import numpy as np\n"
        "from mdeical_image_segmentation_tpu_torch.cli import predict3d, "
        "train3d\n"
        "from mdeical_image_segmentation_tpu_torch.configs import "
        "load_config\n"
        "from mdeical_image_segmentation_tpu_torch.data import hdf5 as d\n"
        "from mdeical_image_segmentation_tpu_torch.utils import hdf5\n"
        "cfg = load_config(['--config', 'configs/unet3d_train.yml'])\n"
        "assert cfg['loaders']['train']['transformer']['raw'][3]['axes'] "
        "== [[2, 1]]\n"
        "assert load_config(['--config', 'configs/unet3d_predict.yml'])"
        "['loaders']['batch_size'] == 4\n"
        f"p = {str(tmp_path / 'v.h5')!r}\n"
        "with hdf5.File(p, 'w') as f:\n"
        "    f.create_dataset('raw', data=np.ones((4, 8, 8), 'f4'), "
        "compression='gzip')\n"
        "with hdf5.File(p, 'r+') as f:\n"
        "    f.create_dataset('raw_padded_1x1x1', data=np.ones((6, 10, 10), "
        "'f4'), compression='gzip')\n"
        "with hdf5.File(p) as f:\n"
        "    assert f['raw'][:].sum() == 256\n"
        "    assert f['raw_padded_1x1x1'][:].sum() == 600\n"
        # a libver='latest' file (v2 B-tree index, shuffle + LZF) and
        # h5py's bool and float16, read without h5py
        "fx = 'tests/fixtures/h5_latest/'\n"
        "with hdf5.File(fx + 'filter_lzf.h5') as f:\n"
        "    assert f['x'][:].shape == (6, 10, 11)\n"
        "with hdf5.File(fx + 'dtypes_latest.h5') as f:\n"
        "    assert f['label_bool'][:].dtype == bool\n"
        "    assert f['le_f2'][:].dtype == np.float16\n"
        "from mdeical_image_segmentation_tpu_torch.data import dsb\n"
        # a TIFF, a GIF, a BMP and a JPEG read without PIL, imageio or
        # tifffile
        "from mdeical_image_segmentation_tpu_torch.utils import image\n"
        "fi = 'tests/fixtures/image_formats/'\n"
        "assert image.read(fi + 'drive/21_training.tif', 'RGB').shape == "
        "(584, 565, 3)\n"
        "assert image.imread(fi + 'drive/21_manual1.gif').shape == "
        "(584, 565, 3)\n"
        "assert image.read(fi + 'dsb_c3/images/rle8.bmp', 'L').shape == "
        "(32, 48)\n"
        "assert image.imread(fi + 'jpeg_drive/progressive_422.jpg').shape "
        "== (584, 565, 3)\n"
        # the JAX trainer's orbax checkpoint, read without orbax,
        # tensorstore or zstandard
        "import logging\n"
        "from mdeical_image_segmentation_tpu_torch.train.orbax_ckpt import "
        "OrbaxCheckpointer\n"
        "logging.getLogger('OrbaxCheckpointer').setLevel(logging.WARNING)\n"
        "t = OrbaxCheckpointer('tests/fixtures/orbax/tp/orbax').restore()\n"
        "assert t['model_state_dict']['batch_stats'] == {}\n"
        "from mdeical_image_segmentation_tpu_torch.metrics import hd95\n"
        "from mdeical_image_segmentation_tpu_torch.infer import "
        "DSB2018Predictor, LazyPredictor\n"
        f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok")


def test_card_scripts_import_without_jax_and_share_public_helpers():
    """chip_train_step.py builds phase 9's trainer through chip_smoke.py's
    public helpers only, and each of them exists; neither script pulls in
    JAX or the JAX package when imported."""
    src = open(os.path.join(REPO, "chip_train_step.py")).read()
    used = {n.attr for n in ast.walk(ast.parse(src))
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
            and n.value.id == "chip_smoke"}
    assert {"UNet3DTraining", "plain_path", "SEED"} <= used
    assert not [u for u in used if u.startswith("_")], used
    code = (
        "import sys\n"
        "import chip_smoke, chip_train_step\n"
        f"missing = [u for u in {sorted(used)!r} "
        "if not hasattr(chip_smoke, u)]\n"
        "assert not missing, missing\n"
        "assert hasattr(chip_smoke.UNet3DTraining, 'trainer')\n"
        f"bad = [m for m in {FORBIDDEN + ('mdeical_image_segmentation_tpu',)!r}"
        " if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok")


def test_nvcc_command_targets_sm90a():
    """One nvcc per source, started together, then one link."""
    compiles, link = _build.nvcc_commands(
        "nvcc", _build.BUILD_DIR / "lib.so", _build.BUILD_DIR / "obj")
    assert len(compiles) == len(_build.SOURCES) == 5
    for cmd, src in zip(compiles, _build.SOURCES):
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert {"-O3", "-std=c++17", "-c"} <= set(cmd)
        assert cmd[-1] == str(_build.CSRC / src)
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    assert _build.library_path().parent == _build.BUILD_DIR
    assert _build.library_path().name.startswith("libtpuseg_kernels_")


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """Every file under csrc/ names the library, so an edit to the shared
    conv header alone gives a new path (a stale library is never reused);
    each compile command finds the header on its include path, and the
    package data ships it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    assert _build.library_path() == before  # stable for an unchanged tree
    header = csrc / "conv_tc.cuh"  # included by the two conv sources
    text = header.read_text()
    header.write_text(text + "\n// edited\n")
    assert _build.library_path() != before
    header.write_text(text)
    assert _build.library_path() == before
    compiles, _ = _build.nvcc_commands("nvcc", tmp_path / "lib.so", tmp_path)
    for cmd in compiles:
        assert cmd[cmd.index("-I") + 1] == str(csrc)
    for src in ("double_conv2d.cu", "gcr_conv3d.cu"):
        assert '#include "conv_tc.cuh"' in (csrc / src).read_text()
    pyproject = open(os.path.join(REPO, "pyproject.toml")).read()
    assert '"csrc/*.cu", "csrc/*.cuh"' in pyproject


@pytest.mark.parametrize("source,entry", [
    ("png_unfilter.c", "tpuseg_png_unfilter"),
    ("lzf_decompress.c", "tpuseg_lzf_decompress"),
    ("lzw_decode.c", "tpuseg_tiff_lzw_decode")])
def test_host_c_library_is_named_by_its_source(tmp_path, monkeypatch,
                                               source, entry):
    """csrc/png_unfilter.c, csrc/lzf_decompress.c and csrc/lzw_decode.c
    build with the host C compiler into BUILD_DIR, each under a name that
    changes with its source."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.host_library_path(source)
    assert before.parent == _build.BUILD_DIR
    assert before.name.startswith(f"lib{source[:-2]}_")
    src = csrc / source
    src.write_text(src.read_text() + "\n/* edited */\n")
    assert _build.host_library_path(source) != before
    assert entry in src.read_text()


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_kernel_source_has_the_c_entry_points():
    src = (_build.CSRC / "double_conv2d.cu").read_text()
    assert 'extern "C" int tpuseg_double_conv2d_forward(' in src
    assert "cudaGetLastError()" in src
    assert "_double2d_kernel" in src  # names the TPU kernel it replaces


@pytest.mark.parametrize("source,entry_points,replaces", [
    ("group_norm.cu", ("tpuseg_gn_stats", "tpuseg_gn_affine",
                       "tpuseg_gn_bwd_reduce", "tpuseg_gn_bwd_dx"),
     ("_stats_kernel", "_affine_kernel", "_bwd_reduce_kernel",
      "_bwd_dx_kernel")),
    ("gcr_conv3d.cu", ("tpuseg_gcr_conv3d_forward",), ("_gcr_kernel",)),
    ("overlap_add.cu", ("tpuseg_overlap_add",), ("_overlap_kernel",)),
])
def test_new_kernel_sources_have_entry_points_and_name_their_tpu_kernel(
        source, entry_points, replaces):
    src = (_build.CSRC / source).read_text()
    for name in entry_points:
        assert f'extern "C" int {name}(' in src
        assert f'"{name}"' in open(_build.__file__).read()  # declared
    assert "cudaGetLastError()" in src
    assert "int64_t" in src  # 64-bit offsets: 4.7e9-element activations
    for name in replaces:
        assert name in src


def test_wrappers_keep_launch_counters_and_plain_versions():
    from mdeical_image_segmentation_tpu_torch.ops import norm, overlap

    for fn in (fused_conv.fused_double2d, fused_conv.fused_conv3d,
               norm.gn_channel_sums, norm.gn_affine, norm.gn_bwd_reduce,
               norm.gn_bwd_dx, overlap.overlap_add_into):
        assert isinstance(fn.launches, int)
    for plain in (fused_conv.fused_conv3d_reference,
                  norm.gn_channel_sums_reference, norm.gn_affine_reference,
                  norm.gn_bwd_reduce_reference, norm.gn_bwd_dx_reference,
                  overlap.overlap_add_into_reference):
        assert callable(plain)


def test_cuda_wrapper_checks_run_before_any_launch():
    """Shape and dtype checks are plain Python and raise before the kernel
    library is touched."""
    x = torch.zeros(1, 4, 4, 2)
    w1, b1 = torch.zeros(3, 3, 2, 3), torch.zeros(3)
    w2, b2 = torch.zeros(3, 3, 3, 5), torch.zeros(5)
    fused_conv._check(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w2 must be"):
        fused_conv._check(x, w1, b1, torch.zeros(3, 3, 2, 5), b2)
    with pytest.raises(TypeError, match="b1 is torch.float64"):
        fused_conv._check(x, w1, b1.double(), w2, b2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv._check(x.transpose(1, 2), w1, b1, w2, b2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_conv._check(x.half(), w1.half(), b1.half(), w2.half(),
                          b2.half())
