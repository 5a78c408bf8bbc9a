r"""The PyTorch port stands apart from the JAX package: it imports neither JAX
nor `azula_tpu`, reads no file under `azula_tpu/` (nor does `chip_smoke.py`),
its main path calls no library attention, GroupNorm or compiler, and its
kernels are built for Hopper from sources it ships."""

import ast
import pathlib
import re
import tomllib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "azula_tpu_torch"

SOURCES = sorted(PACKAGE.rglob("*.py"))

FORBIDDEN_ATTRIBUTES = {"scaled_dot_product_attention", "group_norm", "compile"}


def _imports(tree: ast.AST) -> list[str]:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden_import(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "azula_tpu")


def test_sources_found():
    assert len(SOURCES) >= 15
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize(
    # tests/torch_dist.py: the ranks of the multi-rank tests
    "path", SOURCES + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist.py"], ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_import(path):
    tree = ast.parse(path.read_text())
    bad = [name for name in _imports(tree) if _forbidden_import(name)]
    assert not bad, f"{path.name} imports {bad}"


def _docstrings(tree: ast.AST) -> set[int]:
    nodes = (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
    return {
        id(node.body[0].value)
        for node in ast.walk(tree)
        if isinstance(node, nodes) and node.body and isinstance(node.body[0], ast.Expr)
    }


# a path component or a path inside the JAX package; "azula_tpu/<file>.py:<line>"
# (a reference in a message) is no path the code opens
_JAX_PATH = re.compile(r"(^|[^\w.])azula_tpu(?=$|[/\\])(?![/\\][\w/]+\.py:\d)")


def _paths_into_jax(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text())
    skip = _docstrings(tree)
    return [
        f"{path.name}:{node.lineno}: {node.value!r}"
        for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in skip
        and _JAX_PATH.search(node.value)
    ]


@pytest.mark.parametrize(
    "path", SOURCES + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT))
)
def test_reads_no_file_of_the_jax_package(path):
    assert not _paths_into_jax(path)


@pytest.mark.parametrize(
    "text, flagged",
    [
        ('x = "azula_tpu"', True),
        ('x = "azula_tpu/models/manifests/adm"', True),
        ('x = f"{root}/azula_tpu/ops"', True),
        ('x = "azula_tpu/ops/norm.py:463 (_gn_fused_tpu)"', False),
        ('x = "see azula_tpu/ops/attention.py:92 and azula_tpu/ops/conv.py:53"', False),
        ('x = "azula_tpu_torch/csrc/group_norm.cu"', False),
        ('x = "azula_tpu.models.adm"', False),
        ('def f():\n    "a docstring naming azula_tpu/models/manifests"', False),
    ],
)
def test_paths_into_the_jax_package_are_told_from_references(tmp_path, text, flagged):
    source = tmp_path / "source.py"
    source.write_text(text + "\n")
    assert bool(_paths_into_jax(source)) == flagged


def test_manifests_are_the_ports_own():
    manifests = PACKAGE / "models" / "manifests"
    for family in ("adm", "flux", "sana"):
        ours = sorted(p.name for p in (manifests / family).glob("*.json"))
        theirs = sorted(p.name for p in (ROOT / "azula_tpu" / "models" / "manifests" / family).glob("*.json"))
        assert ours and ours == theirs, family
        for name in ours:
            assert (manifests / family / name).read_bytes() == (
                ROOT / "azula_tpu" / "models" / "manifests" / family / name
            ).read_bytes()

    config = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert "manifests/*/*.json" in config["tool"]["setuptools"]["package-data"]["azula_tpu_torch.models"]
    assert '"azula_tpu_torch" / "models" / "manifests"' in (ROOT / "chip_smoke.py").read_text()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_kernels_in_package(path):
    # `F.group_norm`, `F.scaled_dot_product_attention`, `torch.compile`: only
    # chip_smoke.py may time the first two as yardsticks
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in FORBIDDEN_ATTRIBUTES:
            base = node.value
            owner = base.id if isinstance(base, ast.Name) else getattr(base, "attr", "")
            assert owner not in ("F", "functional", "torch"), (
                f"{path.name}:{node.lineno} calls {owner}.{node.attr}"
            )


def test_build_targets_hopper():
    from azula_tpu_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-O3" in flags and "-std=c++17" in flags
    assert _build.BUILD == ROOT / "build"


def test_kernel_sources_exist_and_are_packaged():
    csrc = PACKAGE / "csrc"
    kernels = (
        "group_norm.cu", "attention_fwd.cu", "attention_bwd.cu", "fused_msa.cu", "flash_blhd_fwd.cu", "flash_blhd_bwd.cu",
        "group_stats.cu", "conv3x3.cu",
    )
    for name in (*kernels, "common.cu", "common.cuh"):
        assert (csrc / name).exists(), name

    for name in kernels:
        head = (csrc / name).read_text().split("#include")[0]
        assert "Replaces: azula_tpu/ops/" in head and "Bound on the H100" in head

    head = (csrc / "fused_msa.cu").read_text().split("#include")[0]
    assert "Replaces: azula_tpu/ops/fused_msa.py:200 (_kernel_call)" in head
    head = (csrc / "flash_blhd_fwd.cu").read_text().split("#include")[0]
    assert "Replaces: azula_tpu/ops/attention.py:798 (_flash_blhd" in head
    head = (csrc / "flash_blhd_bwd.cu").read_text().split("#include")[0]
    assert "Replaces: azula_tpu/ops/attention.py:836 (_flash_blhd_bwd" in head
    head = (csrc / "attention_bwd.cu").read_text().split("#include")[0]
    assert "Replaces: azula_tpu/ops/attention.py:1102 (_pallas_attention_bwd" in head
    assert "azula_tpu/ops/attention.py:966" in head
    head = (csrc / "group_stats.cu").read_text().split("#include")[0]
    assert "Replaces: azula_tpu/ops/norm.py:281 (_stats_pallas)" in head
    head = (csrc / "conv3x3.cu").read_text().split("#include")[0]
    assert "Replaces: azula_tpu/ops/conv.py:53 (_pallas_conv3x3)" in head

    config = tomllib.loads((ROOT / "pyproject.toml").read_text())
    data = config["tool"]["setuptools"]["package-data"]
    assert set(data["azula_tpu_torch"]) >= {"csrc/*.cu", "csrc/*.cuh"}
    assert "cards.yaml" in data["azula_tpu_torch.models.*"]
    assert (PACKAGE / "models" / "adm" / "cards.yaml").exists()

    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored


@pytest.mark.parametrize(
    "module", ["debug.py", "utils/data.py", "utils/profiling.py", "parallel/pp.py", "parallel/recipes.py"]
)
def test_the_last_modules_are_checked(module):
    # the modules of the last slice are among the sources the tests above read
    assert PACKAGE / module in SOURCES


def _imported_names(path: pathlib.Path) -> set[str]:
    r"""The names a package's `__init__.py` imports from its own modules."""

    tree = ast.parse(path.read_text())
    return {
        alias.asname or alias.name
        for node in ast.walk(tree)
        if isinstance(node, ast.ImportFrom) and node.level == 1
        for alias in node.names
    }


@pytest.mark.parametrize("package", ["", "parallel"])
def test_exports_cover_the_jax_packages(package):
    # read as text: neither package is imported here
    theirs = _imported_names(ROOT / "azula_tpu" / package / "__init__.py")
    ours = _imported_names(PACKAGE / package / "__init__.py")
    assert theirs and theirs <= ours, sorted(theirs - ours)
