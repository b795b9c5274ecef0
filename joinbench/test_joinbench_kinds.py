"""A configuration's kind is a file of its own (``kinds/<kind>.py``): the
existing kinds draw the same tables and give the same reference answers
as before they were files (pinned digests), the harness refuses a kind
that lacks what its loop needs, no module outside ``kinds/`` names a
kind, and a deployment with a composite key is added as new files only."""

from __future__ import annotations

import ast
import hashlib
import json
import pathlib
import shutil

import pytest
import torch

from joinbench import harness, run, spec
from joinbench.control import Control, control_answer
from joinbench.faults import Faulty
from joinbench.system import Port
from joinbench.tiny import cut, tiny

HERE = pathlib.Path(__file__).resolve().parent
CPU = torch.device("cpu")
KINDS = sorted(p.stem for p in (HERE / "kinds").glob("*.py"))
# What a kind module may import: it judges the program, so nothing of it.
KIND_IMPORTS = {"__future__", "torch", "numpy", "joinbench", "joinbench.datagen",
                "joinbench.reference"}

# sha256 of the tiny-size tables (``tiny``) of every cell, the reference's answer to them and
# the control's, taken on the harness as it was before kinds were files. A world's share is
# rank r of 2; "answer" there holds the owner of each row too.
PINNED = {
    "int64-100m.join/4000000007/inputs": "ac73dbb4fd8d9e75cdac69b82fe7410805f1768c6373275576b9c922c5d31adc",
    "int64-100m.join/4000000007/answer": "bb008dd540dfd8f17d5ae8eaa8a68b1ec46fb6762d11c51d9debd3ceee79b09c",
    "int64-100m.join/4000000007/control": "bb008dd540dfd8f17d5ae8eaa8a68b1ec46fb6762d11c51d9debd3ceee79b09c",
    "tpch-sf100-split8.join/4000000007/inputs": "968b6dc7abdc1e30f11aca1c5fe4b8169088b2681ca0056935a2e85b1169afb9",
    "tpch-sf100-split8.join/4000000007/answer": "f9f8b8dc39b574034f481d6fb3d9d03b511ebdabd1f01c5088923122f59657b1",
    "tpch-sf100-split8.join/4000000007/control": "cccec66bec134e2201fbf851af539028c9af576aa0bcbcb2b7ab1132f0dab413",
    "int64-100m.serve/4000000007/inputs": "df05d266d0a1a1ed1cb1ffbda2f15a7673fe2c98802f2fe45559995ca8a7485e",
    "int64-100m.serve/4000000007/answer": "038ac2c40d3265e457eee413292cb5704872d0d668ec9a3557f09376def159bd",
    "int64-100m.join.w4/4000000007/rank0/inputs": "75d780a38d072fe89f300161fdababdef13ca125eb0682b0a3e54be0cef32c33",
    "int64-100m.join.w4/4000000007/rank0/answer": "8842a96bd8e3b48603e89c31fedf4517dffb71583d961c21d56466ae7a8481e1",
    "int64-100m.join.w4/4000000007/rank0/control": "91124ab3724d237bf3ccc6eb67868968cd92251ded479b92acf4b7afba7b84ef",
    "int64-100m.join.w4/4000000007/rank1/inputs": "ecbeddba2b6766d84f5859ebf072db1ad6cf10439c27413eb851dc68039089c2",
    "int64-100m.join.w4/4000000007/rank1/answer": "a2a5e470e69d46cfa4d051cb234711aec7f9861171a13cb4d88dce908bdd779e",
    "int64-100m.join.w4/4000000007/rank1/control": "a39708f55144f524606166eb542fcf63228bb9ce7c2065bb1d6431cb6caad735",
    "int64-100m.join/3/inputs": "5dea23e9473bc80b3ffe44c039d53a6447d89e988245355391283d9ba96587ee",
    "int64-100m.join/3/answer": "3c6962d9ebcb0c06aca30009f2e406fdc8039500314702f830052ae8b45535a1",
    "int64-100m.join/3/control": "3c6962d9ebcb0c06aca30009f2e406fdc8039500314702f830052ae8b45535a1",
    "tpch-sf100-split8.join/3/inputs": "d67142c436c68acdae01852054b0d02c8749f1a35bc8a1cd0b4a386c32d76ac7",
    "tpch-sf100-split8.join/3/answer": "f8e477ebdfd7fd0c6b0699646d8f7812fb4aa7e17ed5fe47630a6e1e52be7e98",
    "tpch-sf100-split8.join/3/control": "0a7d28e182dbc41d2ebe480b7d9eb62c06288f853c04335486b0671fd2c1a0d8",
    "int64-100m.serve/3/inputs": "2760a9826cd2ad1bbe81e288e489ac0d6b11480c2f1722e6a2393210d8d7ff12",
    "int64-100m.serve/3/answer": "8f96ef7fd6656ee0f2742ac1ac22722f4847f724ac6966d8dfbcab0696703ddc",
    "int64-100m.join.w4/3/rank0/inputs": "1fa6525a54dc39ce93d3cfddd61d2b9a333da615a8a888932af5407b1dfe6486",
    "int64-100m.join.w4/3/rank0/answer": "df7587db4f68d7adeb1d08da5e56dd4e73238cef2050c32fc83bdb750812fe34",
    "int64-100m.join.w4/3/rank0/control": "2706e6894904a7d38f59ac560105800d5f82b1f7767ea5d27a326efe7536f9af",
    "int64-100m.join.w4/3/rank1/inputs": "33c0c5650211a31c82845851b6d713ad61ed3afd4806444c10de6d3010144dfd",
    "int64-100m.join.w4/3/rank1/answer": "ac64623241384fa06f0b78aeb7ccee55ea7b7ce4c5543574213f325df4182071",
    "int64-100m.join.w4/3/rank1/control": "8567a4e5ee415942bce8b72c0b47091ab67596ef1d6787987ce617cf8bcb13d9",
}
SEEDS = (4000000007, 3)
CELLS = ("int64-100m.join", "tpch-sf100-split8.join", "int64-100m.serve", "int64-100m.join.w4")


def _flat(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _flat(y)]
    return [torch.tensor(x, dtype=torch.int64)]


def digest(x) -> str:
    """sha256 of each tensor's dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for t in _flat(x):
        t = t.detach().cpu().contiguous()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _digests(name: str, seed: int) -> dict:
    cell = tiny(name)
    kind, cfg = cell.kind, cell.config
    key = f"{name}/{seed}"
    if cell.traffic["ranks"] > 1:
        out = {}
        build = kind.world_build_side(cfg, seed, 2, CPU)
        for r in range(2):
            inputs = kind.world_inputs(cfg, seed, r, 2, CPU)
            left, right = kind.sides(inputs)
            ans = kind.expected_rows(dict(inputs, build_keys=build[0], build_payload=build[1]))
            out[f"{key}/rank{r}/inputs"] = digest([left, right, kind.expected_count(inputs),
                                                   build])
            out[f"{key}/rank{r}/answer"] = digest([ans, kind.world_owner(cfg, ans)])
            out[f"{key}/rank{r}/control"] = digest(
                control_answer(kind, cfg["control"], left, build).columns)
        return out
    if cell.traffic["loop"] == "open":
        tr = cell.traffic
        inputs = kind.inputs(cfg, seed, CPU, probe=False)
        queries = [harness.probe_query(kind, inputs, CPU, seed, (2, i), rows, tr["selectivity"])
                   for i, rows in enumerate((tr["probe_rows_min"], tr["probe_rows_max"]))]
        return {f"{key}/inputs": digest([kind.sides(inputs)[1],
                                         [[kind.sides(q)[0], kind.expected_count(q)]
                                          for q in queries]]),
                f"{key}/answer": digest([kind.expected_rows(q) for q in queries])}
    inputs = kind.inputs(cfg, seed, CPU)
    left, right = kind.sides(inputs)
    return {f"{key}/inputs": digest([left, right, kind.expected_count(inputs)]),
            f"{key}/answer": digest(kind.expected_rows(inputs)),
            f"{key}/control": digest(control_answer(kind, cfg["control"], left, right).columns)}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_tiny_inputs_and_answers_keep_their_digests(name, seed):
    got = _digests(name, seed)
    assert got == {k: PINNED[k] for k in got}
    assert len(got) == sum(k.startswith(f"{name}/{seed}/") for k in PINNED)


@pytest.mark.parametrize("kind", KINDS)
def test_a_kind_gives_every_hook_and_imports_only_the_reference_side(kind):
    mod = spec.load_kind(kind)
    assert all(hasattr(mod, h) for h in spec.KIND_HOOKS)
    assert mod.KEYS["control"] == mod.CONTROLS
    assert _kind_imports(HERE / "kinds" / f"{kind}.py") <= KIND_IMPORTS


def _kind_imports(path: pathlib.Path) -> set:
    """Every module ``path`` imports, a ``from joinbench import x`` as
    ``joinbench.x``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
            if node.module == "joinbench":
                names |= {f"joinbench.{a.name}" for a in node.names}
    return names


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(HERE)) for p in [*HERE.glob("*.py"), *HERE.glob("metrics/*.py")]
    if not p.name.startswith(("test_", "conftest"))))
def test_no_module_outside_kinds_names_a_kind(path):
    """A kind is found by its configuration's ``kind``: no other module
    holds a kind's name as a string, so none can branch on it."""
    consts = {n.value for n in ast.walk(ast.parse((HERE / path).read_text()))
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert not consts & set(KINDS)
    assert "CONFIG_KEYS" not in (HERE / path).read_text()


@pytest.mark.parametrize("config, mix, missing", [
    ("tpch-sf100-split8", "serve", "probe"),
    ("tpch-sf100-split8", "join.w4", "world_inputs"),
    ("int64-100m", "join", None),
])
def test_a_kind_without_the_hooks_of_its_loop_is_refused(config, mix, missing):
    """The open loop needs ``probe`` and ``key_range``, a world of ranks
    the world hooks: a kind without them is refused by name."""
    cfg, traffic = spec.load_config(config), spec.load_traffic(mix)
    if missing is None:
        assert spec.check(cfg, traffic).__name__ == "joinbench_kind_int64"
        return
    with pytest.raises(ValueError, match=missing):
        spec.check(cfg, traffic)


def test_an_unknown_kind_is_refused():
    cfg = dict(spec.load_config("int64-100m"), kind="int128")
    with pytest.raises(ValueError, match="int128"):
        spec.check(cfg, spec.load_traffic("join"))


# A toy TPC-H partsupp JOIN lineitem on (partkey, suppkey), as a later deployment would add it.
PAIRKEY = '''"""A toy TPC-H lineitem JOIN partsupp on (partkey, suppkey): 4 suppliers
a part by TPC-H's rule, each lineitem one of its part's 4; an int64 row
id a side. The control matches on the partkey alone."""

from __future__ import annotations

import torch

from joinbench import datagen, reference

CONTROLS = ("partkey_only",)
KEYS = {"kind": None, "parts": None, "suppliers": None, "lineitems": None,
        "join_config": None, "control": CONTROLS}


def check(cfg, traffic):
    if not (100 <= cfg["suppliers"] and cfg["parts"] <= 20 * cfg["suppliers"]):
        raise ValueError("TPC-H's rule gives a part 4 distinct suppliers at 20 parts a "
                         "supplier or fewer")


def _suppkey(part, i, s):
    return (part + i * (s // 4 + (part - 1) // s)) % s + 1


def inputs(cfg, seed, device, probe=True):
    gen = datagen.generator(device, seed, 0)
    p, s, n = cfg["parts"], cfg["suppliers"], cfg["lineitems"]
    part = torch.arange(1, p + 1, device=device).repeat_interleave(4)
    i = torch.arange(4, device=device).repeat(p)
    order = torch.randperm(4 * p, generator=gen, device=device)
    l_part = torch.randint(1, p + 1, (n,), generator=gen, device=device)
    l_i = torch.randint(0, 4, (n,), generator=gen, device=device)
    return {"l_partkey": l_part, "l_suppkey": _suppkey(l_part, l_i, s),
            "l_row": torch.arange(n, device=device),
            "ps_partkey": part[order], "ps_suppkey": _suppkey(part, i, s)[order],
            "ps_row": torch.arange(4 * p, device=device)}


def sides(inputs):
    return ([inputs["l_partkey"], inputs["l_suppkey"], inputs["l_row"]],
            [inputs["ps_partkey"], inputs["ps_suppkey"], inputs["ps_row"]])


def on(cfg):
    return (0, 1), (0, 1)


def expected_count(inputs):
    return int(inputs["l_partkey"].shape[0])


def _rows(left, right, li, ri):
    return [left[0][li], left[1][li], left[2][li], right[2][ri]]


def rows_wrong(inputs, got):
    left, right = sides(inputs)
    li, ri = reference.match_pairs(left[:2], right[:2])
    return reference.rows_wrong_int(got, _rows(left, right, li, ri))


def control(mode, left, right):
    li, ri = reference.match_pairs(left[0], right[0])
    return _rows(left, right, li, ri)


def tiny(cfg, rows):
    return dict(cfg, lineitems=rows, parts=rows // 2, suppliers=max(100, rows // 40))
'''


@pytest.fixture
def pairkey_checkout(tmp_path):
    """A copy of the benchmark with a composite-key deployment added as
    new files and new entries only; yields (cell, the files that were
    there with their bytes, BENCHMARK.json aside)."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "joinbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    new = root / "joinbench"
    (new / "kinds" / "pairkey.py").write_text(PAIRKEY)
    (new / "configs" / "tpch-partsupp-toy.json").write_text(json.dumps({
        "source": "a test", "kind": "pairkey", "parts": 2000, "suppliers": 100,
        "lineitems": 6000, "join_config": {"over_decom_factor": 1},
        "control": "partkey_only", "reduced": []}))
    (new / "traffic" / "join.pairkey.json").write_text(json.dumps(
        {"loop": "closed", "ranks": 1, "clients": 1, "trace_calls": 3}))
    bench["configs"].append({"name": "tpch-partsupp-toy", "source": "a test",
                             "file": "joinbench/configs/tpch-partsupp-toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tpch-partsupp-toy.join", "config": "tpch-partsupp-toy",
                               "traffic": "join.pairkey", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    del before[root / "BENCHMARK.json"]  # it gains entries
    return spec.resolve("tpch-partsupp-toy.join", here=new), before


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("system", ["port", "control", "half", "altered"])
def test_a_composite_key_deployment_is_added_as_files_only(pairkey_checkout, system,
                                                          few_threads):
    """Through the program on the CPU the toy's two-column key reads
    correct; with the kind's control in the program's place, or a fault
    planted under it, not."""
    cell, before = pairkey_checkout
    assert cell.kind.__name__ == "joinbench_kind_pairkey"
    assert _kind_imports(cell.here / "kinds" / "pairkey.py") <= KIND_IMPORTS
    port = Port(CPU)
    stand_in = {"port": port, "control": Control(cell.kind, cell.config["control"], CPU),
                "half": Faulty("half", port), "altered": Faulty("altered", port)}[system]
    res = run.run_cell(cut(cell, rows=4000), 4000000019, 0.3, False, device="cpu",
                       system=stand_in)
    if system == "port":
        assert res["correct"] is True
        assert res["checks"]["rows_wrong"]["value"] == 0
        assert res["attempted"] > 0 and res["failed"] == 0
    else:
        assert res["correct"] is False
    assert {p: p.read_bytes() for p in before} == before, "no file that was there changed"
