"""A configuration names its architecture and the harness finds it by
name (``portbench/arch/<name>.py``).

The MAT's counts, initial weights and reference outputs are pinned to the
values the harness gave before the architecture files existed, bit for
bit; and a second architecture, added as new files only, is what
``resolve_cell``, the plan's work, the reference, the roofline readers
and the program's check go through."""

import hashlib
import json

import pytest
import torch

from portbench import program
from portbench.cell import _inputs, _reference, trace_context
from portbench.counts.work import plan_work
from portbench.inputs import make_datasets, make_weights, round_work, \
    sample_round
from portbench.readers import roofline
from portbench.reference.fedcola import Line
from portbench.spec import arch_of, metric_reader, resolve_cell
from portbench.tests.tinyroot import REPO, TINY, make_root, tiny_traffic
from portbench.tree import leaves

# model_flops and each route's least seconds of one round (the first timed
# one) and one evaluation pass, as float.hex, from the harness before the
# architecture files
WORK = {
    "mome_small/coco-pop": ("0x1.04953d7bac000p+48", {
        "fused": "0x1.58dadb8ef01cbp-2", "flash": "0x1.01ba851bd412cp-4"}),
    "mome_small/coco-eval5k": ("0x1.616b732f80000p+47", {
        "fused": "0x1.8ebf9a4bfadc0p-3", "flash": "0x1.7feecd0479aefp-5"}),
    "mome_tiny/coco-pop": ("0x1.190071df58000p+46", {
        "fused": "0x1.8370f406c455bp-4", "flash": "0x1.01ba851bd412cp-5"}),
    "mome_tiny/coco-eval5k": ("0x1.79d782df00000p+45", {
        "fused": "0x1.a6f5666ea16fap-5", "flash": "0x1.7feecd0479aefp-6"}),
    "tiny/pop-tiny": ("0x1.8aa3800000000p+27", {
        "fused": "0x1.edb21261f5621p-20", "flash": "0x1.812d84003d589p-21"}),
    "tiny/eval-tiny": ("0x1.f996000000000p+23", {
        "fused": "0x1.df45ae985e541p-24", "flash": "0x1.44ee284496bb2p-24"}),
}

# the same over a window: the plan's next 8 rounds, or 12 passes
WINDOW = {
    "mome_small/coco-pop": (8, "0x1.06e6825f3f000p+51", {
        "fused": "0x1.5bfc9470fe1d9p+1", "flash": "0x1.03eb5faf95750p-1"}),
    "mome_small/coco-eval5k": (12, "0x1.09109663a0000p+51", {
        "fused": "0x1.2b0fb3b8fc248p+1", "flash": "0x1.1ff319c35b42dp-1"}),
    "mome_tiny/coco-pop": (8, "0x1.1b96b01e7e000p+49", {
        "fused": "0x1.871003b530ae6p-1", "flash": "0x1.03eb5faf95750p-2"}),
    "mome_tiny/coco-eval5k": (12, "0x1.1b61a22740000p+49", {
        "fused": "0x1.3d380cd2f912ep-1", "flash": "0x1.1ff319c35b42dp-2"}),
    "tiny/pop-tiny": (8, "0x1.89ed400000000p+30", {
        "fused": "0x1.f50e6be0d0b80p-17", "flash": "0x1.7f91efef5def2p-18"}),
    "tiny/eval-tiny": (12, "0x1.7b30800000000p+27", {
        "fused": "0x1.677442f246befp-20", "flash": "0x1.e7653c66e218ap-21"}),
}

# sha256 of each model's initial weights (path, then bytes, leaf by leaf)
WEIGHTS = {
    ("mome_tiny", 3): {
        "CIFAR100": "9f31e913d0b59e71513f5137330165973b364a872a8fa3921821ab4cce5e45ae",
        "AG_NEWS": "5f91a6aef2fb96771a5d920451eff67b6780f3a3e55817cabd9cec5ca7d704eb",
        "Coco": "8a0a734301585a277d80efab67e66a4cfb2a6bfa0726686753611119b867dffb"},
    ("mome_tiny", 2 ** 31 + 7): {
        "CIFAR100": "bd1c1990cd55980f6fde615c18a6f3af828738e10fbe6bd7147f5035a3e36f21",
        "AG_NEWS": "89943c625e13fcc30c35cf2d0fef3606f2f8fceffb441e714ecd9cda20e4c3f9",
        "Coco": "74d20a1e3f67ea3d43fd6072d04f77132d09345cfa827b672172784d59f04320"},
    ("tiny", 3): {
        "CIFAR100": "b6209a6ccb0d7193c726bcab078813319bf71a04e4c25b71bf43ba5018fa0b4d",
        "AG_NEWS": "1e9e8733f19953ae02553e6781c96d4783d8e0552da09464f6ff8354e8b83510",
        "Coco": "217c7039adf419cf1a8465938676286284c4fe4d0587a2dde59986ebd6bacebe"},
    ("tiny", 2 ** 31 + 7): {
        "CIFAR100": "8c1229f16eb713dd859dcdec9fc7f7b8bb97da9cd172705cf782b948ab7d3e74",
        "AG_NEWS": "fb4487f5606d5f26e2f77a465304e9cae0eba68a63bf718cdbca1df4571fd997",
        "Coco": "031506bd811b6ed9f3cc4d7c00f0bdc480cd250af1e59b58b428193f2e88ba88"},
}

# the reference at test width: each followed round's client losses, each
# classification set's test loss (float.hex), and a sha256 of all it
# returns (the evaluations, each parameter's change, the first gradients)
REFERENCE = {
    "pop.tiny": {
        "seed": 2 ** 31 + 99,
        "losses": {
            1: {0: "0x1.26f69f999999ap+2", 2: "0x1.25bffe7777777p+2",
                4: "0x1.6840b58000000p+0", 5: "0x1.48876caaaaaabp+0",
                9: "0x1.ffde5d70a3d71p+0", 10: "0x1.009cb23d70a3dp+1"},
            2: {0: "0x1.2743d2ccccccdp+2", 2: "0x1.2586372222222p+2",
                6: "0x1.72a283999999ap+0", 7: "0x1.6e59999249249p+0",
                8: "0x1.ff3859999999ap+0", 9: "0x1.ff237851eb852p+0"}},
        "eval_loss": {"CIFAR100": "0x1.2644e6ccccccdp+2",
                      "AG_NEWS": "0x1.694aa0ccccccdp+0"},
        "digest": "39099da4fef57144079f1b470a1d8752c14e75865d18453f496c19ef35fecf5b"},
    "eval.tiny": {
        "seed": 41,
        "losses": {},
        "eval_loss": {"CIFAR100": "0x1.25d863999999ap+2",
                      "AG_NEWS": "0x1.6af6973333333p+0"},
        "digest": "a0ed4258ce0f48ccd1c29dab1080e22697ca05ec2ed36d6c9573a280fb87af0d"},
}


def _config(name):
    if name == "tiny":
        return TINY
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def _traffic(name):
    if name in ("pop-tiny", "eval-tiny"):
        return tiny_traffic("rounds" if name == "pop-tiny" else "eval")
    t = json.loads((REPO / "portbench" / "traffic" / f"{name}.json")
                   .read_text())
    for d in t["datasets"].values():
        d["pixels"] = 8         # the counts read no pixel
    return t


def _plan(arch, config, traffic, evals=1):
    """The work of the first ``evals`` timed rounds (none in an evaluation
    mix) and as many evaluation passes."""
    line = Line.from_flags(traffic["flags"])
    data = make_datasets(traffic, arch.data_shapes(config), 5, "cpu")
    works = []
    if traffic["mode"] == "rounds":
        first = int(traffic["follow_rounds"]) + 1
        works = [round_work(data, sample_round(line.seed, data,
                                               line.fraction, r),
                            line.epochs, line.batch)
                 for r in range(first, first + evals)]
    return data, works, plan_work(arch, config, data, works, evals,
                                  line.eval_batch)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("case", sorted(WORK))
def test_work_is_pinned(case, window):
    cname, tname = case.split("/")
    config = _config(cname)
    arch = arch_of(REPO, config.get("architecture", "mat"))
    evals, flops, least = WINDOW[case] if window else (1, *WORK[case])
    _, _, work = _plan(arch, config, _traffic(tname), evals)
    assert work["model_flops"].hex() == flops
    assert {r: v.hex() for r, v in work["least"].items()} == least


def _digest(tree):
    m = hashlib.sha256()
    for path, x in leaves(tree):
        m.update(repr(path).encode())
        m.update(x.contiguous().numpy().tobytes())
    return m.hexdigest()


@pytest.mark.parametrize("cname, seed", sorted(WEIGHTS))
def test_weights_are_pinned(cname, seed):
    config = _config(cname)
    arch = arch_of(REPO, "mat")
    traffic = _traffic("pop-tiny" if cname == "tiny" else "coco-pop")
    line = Line.from_flags(traffic["flags"])
    data = make_datasets(traffic, arch.data_shapes(config), 5, "cpu")
    layouts = {d.name: arch.layout(arch.model_spec(
        config, d.modality, d.task, d.classes, line.with_aux)) for d in data}
    weights = make_weights(layouts, seed, "cpu", arch)
    assert {ds: _digest(t) for ds, t in weights.items()} == \
        WEIGHTS[(cname, seed)]


def test_drawn_kinds_share_the_stream():
    # an architecture's own init kind takes its leaf's share of the one
    # stream, in layout order, as ``normal`` would
    class Arch:
        DRAWN = {"neg": lambda t: -t}
    plain = {"m": [(("a",), (3, 2), "normal"), (("b",), (4,), "normal"),
                   (("c",), (2,), "one")]}
    own = {"m": [(("a",), (3, 2), "normal"), (("b",), (4,), "neg"),
                 (("c",), (2,), "one")]}
    want = make_weights(plain, 2 ** 31 + 3, "cpu", Arch)["m"]
    got = make_weights(own, 2 ** 31 + 3, "cpu", Arch)["m"]
    assert torch.equal(got["a"], want["a"])
    assert torch.equal(got["b"], -want["b"])
    assert torch.equal(got["c"], want["c"])
    with pytest.raises(ValueError, match="unknown init kind"):
        make_weights({"m": [(("a",), (2,), "odd")]}, 1, "cpu", Arch)


def _hex(x):
    if isinstance(x, dict):
        return {str(k): _hex(v) for k, v in x.items()}
    return float(x).hex()


def _norms_digest(d):
    return hashlib.sha256(json.dumps(sorted(
        (str(k), float(v).hex()) for k, v in d.items())).encode()).hexdigest()


def _reference_of(cell, seed):
    follow = int(cell.traffic["follow_rounds"]) \
        if cell.traffic["mode"] == "rounds" else 0
    return _reference(cell, seed, "cpu", follow, max(follow, 1))


def _check_pinned(ref, want):
    assert {r: {c: v.hex() for c, v in ls.items()}
            for r, ls in ref["losses"].items()} == want["losses"]
    assert {ds: e["loss"].hex() for ds, e in ref["eval"].items()
            if "loss" in e} == want["eval_loss"]
    whole = {"eval": _hex(ref["eval"]),
             "init_eval": _hex(ref["init_eval"]) if ref["init_eval"]
             else None,
             "delta": {ds: _norms_digest(d) for ds, d in ref["delta"].items()},
             "grads": {ds: _norms_digest(d) for ds, d in ref["grads"].items()}}
    assert hashlib.sha256(json.dumps(whole, sort_keys=True).encode()) \
        .hexdigest() == want["digest"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_reference_is_pinned(root, name):
    cell = resolve_cell(root, name)
    assert cell.architecture == "mat"
    _check_pinned(_reference_of(cell, REFERENCE[name]["seed"]),
                  REFERENCE[name])


TOY = '''"""The MAT, its FLOPs counted twice, a route of its own, and a program
check no program meets."""

from portbench.arch import Route, mat

CALLS = []


def __getattr__(name):
    return getattr(mat, name)


def forward(*args, **kwargs):
    CALLS.append("forward")
    return mat.forward(*args, **kwargs)


def forward_flops(config, tower, classes=0):
    return 2 * mat.forward_flops(config, tower, classes)


def routes():
    return {**mat.routes(),
            "toy": Route(("fc_toy",), lambda rows, n, N, layer, training:
                         float(rows * N))}


def program_check(config):
    return {**mat.program_check(config), "toy_layers": 2}
'''


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    """A root with the tiny cells, then the toy's files and entries."""
    root = make_root(tmp_path_factory.mktemp("toyroot"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    p = root / "portbench"
    (p / "arch" / "toy.py").write_text(TOY)
    (p / "configs" / "toy.json").write_text(json.dumps(
        {**TINY, "architecture": "toy"}))
    (p / "metrics" / "toy_roofline.train.py").write_text(
        (p / "metrics" / "fused_roofline.train.py").read_text())
    (p / "limits" / "pop.toy.json").write_text(
        (p / "limits" / "pop.tiny.json").read_text())
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "toy", "source": "test width",
                         "file": "portbench/configs/toy.json",
                         "reduced": [], "why": "CPU tests"})
    b["workloads"].append({"name": "pop.toy", "config": "toy",
                           "traffic": "pop-tiny", "chips": 1,
                           "why": "CPU tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "pop.tiny" in m.get("workloads", []):
            m["workloads"].append("pop.toy")
    b["per_layer"].append({"name": "toy_roofline.train", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "kernels",
                           "moves": "train_samples_per_s",
                           "workloads": ["pop.toy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    yield root
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_toy_is_found_by_name(toy_root):
    cell = resolve_cell(toy_root, "pop.toy")
    assert cell.architecture == "toy"
    assert cell.arch.__file__ == str(toy_root / "portbench" / "arch"
                                     / "toy.py")
    assert "toy_roofline.train" in {m.name for m in cell.per_layer}
    assert resolve_cell(toy_root, "pop.tiny").architecture == "mat"


def test_toy_work(toy_root):
    cell = resolve_cell(toy_root, "pop.toy")
    data, works, work = _plan(cell.arch, cell.config, cell.traffic)
    flops, least = WORK["tiny/pop-tiny"]
    assert work["model_flops"] == 2 * float.fromhex(flops)
    assert {r: work["least"][r].hex() for r in least} == least
    # the toy route: rows x N a layer, TINY's 2 layers, both towers' N
    N = {"img": 5, "txt": 12}
    towers = {"img": ("img",), "txt": ("txt",), "img+txt": ("img", "txt")}
    want = sum(rows * N[t] for d in data
               for rows in works[0].step_rows.get(d.name, ())
               for t in towers[d.modality])
    for d in data:
        if d.task == "cls":
            want += len(d.test["targets"]) * N[towers[d.modality][0]]
        else:
            want += len(d.test["image_store"]) * N["img"] + \
                len(d.test["texts"]) * N["txt"]
    assert work["least"]["toy"] == 2 * want


def test_toy_reference(toy_root):
    cell = resolve_cell(toy_root, "pop.toy")
    ref = _reference_of(cell, REFERENCE["pop.tiny"]["seed"])
    assert cell.arch.CALLS
    _check_pinned(ref, REFERENCE["pop.tiny"])


def test_toy_roofline(toy_root):
    cell = resolve_cell(toy_root, "pop.toy")
    work = {"least": {"fused": 0.5, "flash": 0.0, "toy": 0.25}}
    summary = {"ranges": {"fc_toy": 1.0, "fc_attn_fwd": 2.0}}
    ctx = trace_context(cell, summary, work, {"records": []})
    assert roofline(ctx, "toy") == pytest.approx(25.0)
    assert metric_reader(toy_root, "toy_roofline.train")(ctx) == \
        pytest.approx(25.0)
    assert metric_reader(toy_root, "fused_roofline.train")(ctx) == \
        pytest.approx(25.0)
    # a MAT cell has no toy route: nothing to read
    mat_ctx = trace_context(resolve_cell(toy_root, "pop.tiny"), summary,
                            work, {"records": []})
    assert metric_reader(toy_root, "toy_roofline.train")(mat_ctx) is None


def test_program_refuses_toy(toy_root, tmp_path):
    cell = resolve_cell(toy_root, "pop.toy")
    _, data, layouts = _inputs(cell, 5, "cpu")
    weights = make_weights(layouts, 5, "cpu", cell.arch)
    with pytest.raises(RuntimeError, match="architecture 'toy'") as e:
        program.create(cell, data, weights, "cpu", str(tmp_path))
    assert "toy_layers" in str(e.value)
    assert "layout" not in str(e.value)
