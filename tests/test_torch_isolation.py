"""The port stands alone: no file of ``pbrt_torch/`` and not
``chip_smoke.py`` imports JAX or the JAX package (only the tests import
both). Checked on the syntax tree, so names in docstrings and the
``replaces`` field of chip_smoke's kernels line (a file:line of the TPU
kernel) do not count, but every import form does, including
``importlib.import_module`` and ``__import__`` with a literal name."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "pbrt_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "pbrt_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value


def test_files_found():
    assert len(FILES) > 20
    assert (ROOT / "pbrt_torch" / "accel" / "traverse_cuda.py") in FILES


@pytest.mark.parametrize("module", ["cameras/realistic.py", "cameras/eye.py",
                                    "renderers/spectral.py", "renderers/cameras_renderer.py",
                                    "renderers/dispatch.py", "cli.py", "media/volumes.py",
                                    "media/__init__.py"])
def test_lens_camera_and_renderer_modules_covered(module):
    """The lens cameras, the renderers and the command line are among the
    files checked above."""
    assert ROOT / "pbrt_torch" / module in FILES


@pytest.mark.parametrize("module", ["accel/kdtree.py", "accel/grid.py", "accel/traverse_kd.py",
                                    "accel/prims.py", "shapes/loopsubdiv.py", "shapes/nurbs.py",
                                    "renderers/aggregatetest.py"])
def test_accelerator_shape_and_image_modules_covered(module):
    """The kd-tree and grid (builds and walks), the primitive tests, the
    refined shapes and aggregatetest are among the files checked above."""
    assert ROOT / "pbrt_torch" / module in FILES


def test_jpeg_reader_imports_pillow_only_where_it_reads():
    """``film/imageio.py`` imports Pillow inside a function, never at the
    top of the module (the card's machine has no Pillow)."""
    tree = ast.parse((ROOT / "pbrt_torch" / "film" / "imageio.py").read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top for a in n.names] + [
        n.module for n in top if isinstance(n, ast.ImportFrom)]
    assert not any(str(m).split(".")[0] == "PIL" for m in names)
    assert "from PIL import Image" in (ROOT / "pbrt_torch" / "film" / "imageio.py").read_text()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", ["integrators/dipole.py", "integrators/photonmap.py",
                                    "integrators/igi.py", "integrators/irradiance.py",
                                    "renderers/surface_points.py"])
def test_preprocess_integrator_modules_covered(module):
    """The dipole, photon-map, IGI and irradiance-cache integrators and the
    surface-points renderer are among the files checked above."""
    assert ROOT / "pbrt_torch" / module in FILES


@pytest.mark.parametrize("module", ["core/sh.py", "integrators/prt.py", "integrators/bdpt.py",
                                    "renderers/probes.py", "renderers/metropolis.py"])
def test_prt_probe_and_metropolis_modules_covered(module):
    """Spherical harmonics, the PRT integrators, the bidirectional
    estimator, the probes and the Metropolis renderer are among the files
    checked above."""
    assert ROOT / "pbrt_torch" / module in FILES


@pytest.mark.parametrize("module", ["integrators/grad.py", "film/checkpoint.py", "tools.py",
                                    "utils/stats.py", "parallel/shard.py",
                                    "parallel/__init__.py"])
def test_gradient_checkpoint_tool_and_shard_modules_covered(module):
    """The gradient API, checkpoints, the offline tools, the statistics
    and the sharded renderer are among the files checked above."""
    assert ROOT / "pbrt_torch" / module in FILES


@pytest.mark.parametrize("module", ["scripts/gather_lab.py", "scripts/kd_grid_lab.py",
                                    "scripts/mo_lab.py"])
def test_lab_modules_covered(module):
    """The kernel labs (the gather lab, the kd / grid lab and the Mo
    gather's) are among the files checked above."""
    assert ROOT / "pbrt_torch" / module in FILES


def test_tools_import_pillow_only_where_they_write_it():
    """``tools.py`` imports Pillow nowhere itself (its TIFF output goes
    through ``imageio._pillow``), and torch only inside ``bsdftest``."""
    text = (ROOT / "pbrt_torch" / "tools.py").read_text()
    assert "PIL" not in {m.split(".")[0] for m in _imports(ROOT / "pbrt_torch" / "tools.py")}
    tree = ast.parse(text)
    top = {a.name for n in tree.body if isinstance(n, ast.Import) for a in n.names}
    assert "torch" not in top and "_pillow()" in text
