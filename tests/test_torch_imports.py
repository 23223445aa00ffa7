"""The port stands alone: no file of tpu_ac_torch/, not chip_smoke.py and
not scripts/{kernel_ab,serving_host_torch,alpha_ab}.py imports jax, jaxlib
or tpu_ac (as distinct from tpu_ac_torch), nor sklearn, which the card's
machine does not have; the serving host imports nothing of tpu_ac_torch
either.  No module of tpu_ac_torch/ imports matplotlib, cv2 or skimage
when it is imported (only inside the functions that draw): the card's
machine has none of them."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "tpu_ac", "sklearn")
DRAWING = ("matplotlib", "cv2", "skimage")
SERVING_HOST = os.path.join(ROOT, "scripts", "serving_host_torch.py")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "kernel_ab.py"), SERVING_HOST,
             os.path.join(ROOT, "scripts", "alpha_ab.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "tpu_ac_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_tpu_ac_import(path):
    bad = sorted({m for m in _imported_roots(path) if m in BANNED})
    assert not bad, f"{path} imports {bad}"


def _import_time_roots(path):
    """Roots of the imports that run when ``path`` is imported: every
    statement outside a function body."""
    with open(path) as f:
        todo = list(ast.parse(f.read(), path).body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        todo.extend(ast.iter_child_nodes(node))


def test_no_drawing_import_at_module_level():
    pkg = os.path.join(ROOT, "tpu_ac_torch")
    bad = {}
    for path in _port_files():
        if path.startswith(pkg + os.sep):
            mods = sorted({m for m in _import_time_roots(path)
                           if m in DRAWING})
            if mods:
                bad[os.path.relpath(path, ROOT)] = mods
    assert not bad, bad
    # the scan sees the imports it must refuse
    viz = os.path.join(pkg, "viz", "plots.py")
    assert "matplotlib" in set(_imported_roots(viz))


def test_serving_host_imports_no_package():
    """scripts/serving_host_torch.py stands alone: nothing of tpu_ac or
    tpu_ac_torch, and its ops come from the artifact; the ops' module it
    loads from there imports only torch, numpy and the standard
    library."""
    assert not {m for m in _imported_roots(SERVING_HOST)
                if m.startswith("tpu_ac")}
    ops = os.path.join(ROOT, "tpu_ac_torch", "kernels", "distances.py")
    with open(ops) as f:
        tree = ast.parse(f.read(), ops)
    top = {a.name.split(".")[0] for node in tree.body
           if isinstance(node, ast.Import) for a in node.names}
    top |= {node.module.split(".")[0] for node in tree.body
            if isinstance(node, ast.ImportFrom)}
    assert top <= {"__future__", "ctypes", "numpy", "torch"}


def test_scan_sees_the_package():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert "chip_smoke.py" in names
    assert os.path.join("scripts", "kernel_ab.py") in names
    assert os.path.join("scripts", "serving_host_torch.py") in names
    assert os.path.join("scripts", "alpha_ab.py") in names
    for mod in ("kernels/distances.py", "kernels/attention.py",
                "models/convert.py", "models/manifest.py", "cli/convert.py",
                "hub.py", "distributed/__init__.py", "distributed/mesh.py",
                "models/resnet.py", "ops/distances.py", "ops/gaussian.py",
                "detect/__init__.py", "detect/sampler.py", "detect/scorer.py",
                "detect/segmentor.py", "detect/metrics.py", "detect/approx.py",
                "detect/patchcore.py", "cli/patchcore.py",
                "models/layers.py", "models/vgg.py", "models/densenet.py",
                "models/inception.py", "models/resnest.py",
                "models/resnetv2.py", "models/efficientnet.py",
                "models/vit_hybrid.py", "models/swin.py", "models/xcit.py",
                "utils/__init__.py", "utils/seeding.py", "utils/logging.py",
                "utils/profiling.py", "utils/checkpoint.py",
                "models/dino_head.py", "train/__init__.py", "train/dino.py",
                "train/optim.py", "data/imagefolder.py", "data/augment.py",
                "data/prefetch.py", "data/device_aug.py", "cli/dino.py",
                "config.py", "data/classification.py",
                "models/resnet_cifar.py", "train/scan.py", "cli/scan.py",
                "train/evals.py", "train/copy_detection.py",
                "train/video_seg.py", "data/__init__.py",
                "data/oxford_paris.py", "cli/eval_knn.py",
                "cli/eval_linear.py", "cli/eval_copy_detection.py",
                "cli/eval_image_retrieval.py",
                "cli/eval_video_segmentation.py", "native.py",
                "distributed/launch.py", "utils/export.py",
                "cli/export.py", "viz/__init__.py", "viz/plots.py",
                "viz/video.py", "cli/draw.py", "cli/visualize_attention.py",
                "cli/video_generation.py", "tutorial.py",
                "distributed/collectives.py", "distributed/mesh.py"):
        assert f"tpu_ac_torch/{mod}" in names


def test_process_group_entry_points_load_no_jax():
    """Importing the modules of the process group and the CLIs that join
    it (what torchrun and the SCAN CLI's spawned ranks import) loads no
    jax, tpu_ac or sklearn module, however deep."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import tpu_ac_torch.distributed.collectives, "
            "tpu_ac_torch.cli.dino, tpu_ac_torch.cli.scan\n"
            "from tpu_ac_torch.distributed import multihost_init\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{BANNED!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_hub_has_every_factory_of_tpu_ac():
    """Every factory of tpu_ac.hub has its counterpart, and the port's
    module (scanned above) imports no JAX to provide it."""
    import inspect

    from tpu_ac import hub as jhub
    from tpu_ac_torch import hub as thub

    def factories(mod):
        return {n for n, f in inspect.getmembers(mod, inspect.isfunction)
                if f.__module__ == mod.__name__}

    assert factories(thub) == factories(jhub)
    assert {"dino_xcit_small_12_p16", "dino_xcit_medium_24_p8"} <= \
        factories(thub)


def test_manifest_is_the_ports_own():
    """The port reads its own frozen manifests, not tpu_ac's file."""
    from tpu_ac_torch.models.manifest import MANIFEST_PATH

    port = os.path.join(ROOT, "tpu_ac_torch") + os.sep
    assert os.path.abspath(MANIFEST_PATH).startswith(port)
    assert os.path.isfile(MANIFEST_PATH)
