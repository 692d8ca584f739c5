"""The PyTorch port's resident data plane against the JAX package's on the
CPU, from the same numpy inputs:

* ``resident_gather`` / ``_take_images`` for img, txt and img+txt, from
  array-backed and deduplicated stores: exact;
* the ``device_augment`` apply fed JAX's own draws (reproduced from the
  key and its splits as ``fedcola_tpu/parallel/client_update.py``
  draws them): exact, or within 1 uint8 level where a resize runs
  (bilinear in float, rounded back to uint8 by both);
* device augmentation against the host ``_augment`` semantics;
* a path-backed COCO round (PNGs under ``tmp_path``, a deduplicated store
  of 6 images and 30 caption rows) on the resident and the host-fed plane
  (budget 0): every leaf within 1e-6, retrieval results equal; and the
  same round against the JAX server from the same weights (loss 1e-5
  relative, r@1sum within one image and one caption per direction);
* the one-ledger budget, a rotation run fed from the host, a flip run
  staying resident, and CreamFL's public set over the budget fed from the
  host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedcola_tpu import config as jconfig
from fedcola_tpu.data.datasets import TaskDataset as JTaskDataset
from fedcola_tpu.data.loaders import FederatedData as JFederatedData
from fedcola_tpu.data.pipeline import ClientShard as JClientShard
from fedcola_tpu.federation.aggregate import ClientMeta as JClientMeta
from fedcola_tpu.federation.server import FedAvgServer as JFedAvgServer
from fedcola_tpu.parallel import client_update as jcu
from fedcola_tpu_torch import config as tconfig
from fedcola_tpu_torch.data.datasets import TaskDataset
from fedcola_tpu_torch.data.loaders import FederatedData
from fedcola_tpu_torch.data.loaders import load_federated_data as tload
from fedcola_tpu_torch.data.pipeline import AugmentSpec, ClientShard, _augment
from fedcola_tpu_torch.federation.aggregate import ClientMeta
from fedcola_tpu_torch.federation.server import FedAvgServer, create_server
from fedcola_tpu_torch.models import convert
from fedcola_tpu_torch.models.mat import tree_leaves
from fedcola_tpu_torch.parallel import client_update as tcu

# ------------------------------------------------------------- gather ------


def _store(seed=0):
    r = np.random.RandomState(seed)
    n, n_img = 30, 6
    return {"img": r.randint(0, 256, (n, 8, 8, 3)).astype(np.uint8),
            "img_store": r.randint(0, 256, (n_img, 8, 8, 3)).astype(np.uint8),
            "img_row": (np.arange(n) // 5).astype(np.int32),
            "txt": r.randint(0, 100, (n, 6)).astype(np.int32),
            "tgt": r.randint(0, 10, n).astype(np.int32)}


@pytest.mark.parametrize("store", ["array", "dedup"])
@pytest.mark.parametrize("modality", ["img", "txt", "img+txt"])
def test_resident_gather_matches_jax(modality, store):
    data = _store()
    drop = "img_store" if store == "array" else "img"
    data = {k: v for k, v in data.items()
            if k != drop and not (store == "array" and k == "img_row")}
    idx = np.random.RandomState(1).randint(0, 30, (2, 5)).astype(np.int32)
    valid = np.arange(10).reshape(2, 5) % 3 > 0
    jspec = jcu.GroupSpec(modality=modality, criterion="CrossEntropyLoss")
    tspec = tcu.GroupSpec(modality=modality, criterion="CrossEntropyLoss")
    want = jcu.resident_gather(jspec, {k: jnp.asarray(v)
                                       for k, v in data.items()},
                               jnp.asarray(idx), jnp.asarray(valid))
    got = tcu.resident_gather(tspec, {k: torch.from_numpy(v)
                                      for k, v in data.items()},
                              torch.from_numpy(idx), torch.from_numpy(valid))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    if modality != "txt":
        np.testing.assert_array_equal(
            tcu._take_images({k: torch.from_numpy(v)
                              for k, v in data.items()},
                             torch.from_numpy(idx)).numpy(),
            np.asarray(jcu._take_images({k: jnp.asarray(v)
                                         for k, v in data.items()},
                                        jnp.asarray(idx))))


# ---------------------------------------------------- device augmentation --

# (input size, crop, resize, randhf, randvf, tolerance in uint8 levels)
AUG_CASES = {
    "crop": (16, 16, None, None, None, 0),
    "resize_then_crop": (16, 20, 24, None, None, 1),
    "resize_down_then_crop": (32, 16, 16, None, None, 1),
    "pad_if_needed": (8, 32, None, None, None, 0),
    "hflip": (16, None, None, 0.5, None, 0),
    "vflip": (16, None, None, None, 0.5, 0),
    "all": (16, 16, 20, 0.5, 0.5, 1),
}


def _jax_draws(key, B, size, crop, resize, randhf, randvf):
    """The draws of the JAX ``device_augment`` from ``key``, as the port's
    ``AugDraws``."""
    kc, kh, kv = jax.random.split(key, 3)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    d = tcu.AugDraws()
    if crop is not None:
        H = (resize or size) + 8
        H += 2 * max(crop - H, 0)
        kcy, kcx = jax.random.split(kc)
        d.ys = t(jax.random.randint(kcy, (B,), 0, H - crop + 1)).long()
        d.xs = t(jax.random.randint(kcx, (B,), 0, H - crop + 1)).long()
    if randhf is not None:
        d.hflip = t(jax.random.uniform(kh, (B,)) < randhf)
    if randvf is not None:
        d.vflip = t(jax.random.uniform(kv, (B,)) < randvf)
    return d


@pytest.mark.parametrize("case", list(AUG_CASES))
def test_device_augment_apply_matches_jax(case):
    size, crop, resize, randhf, randvf, tol = AUG_CASES[case]
    B = 8
    x = np.random.RandomState(3).randint(0, 256, (B, size, size, 3)) \
        .astype(np.uint8)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jcu.device_augment(jnp.asarray(x), key, crop, randhf,
                                         randvf, resize=resize))
    draws = _jax_draws(key, B, size, crop, resize, randhf, randvf)
    got = tcu.apply_augment(torch.from_numpy(x), draws, crop, resize).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int)).max()
    assert d <= tol, (case, d)
    if randhf is not None or randvf is not None:
        # the draws flip some samples and keep others
        flips = [f for f in (draws.hflip, draws.vflip) if f is not None]
        assert 0 < int(sum(f.long() for f in flips).clamp(max=1).sum()) < B


def test_device_augment_matches_host_semantics():
    """The device twin of the host ``_augment`` (``data/pipeline.py``):
    p=1 flips are exact mirrors, p=0 is the identity, every random crop is
    a c x c window of the 4-padded input and crops vary across samples;
    resize before crop agrees with the host's PIL chain within 1 level on a
    linear ramp."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (6, 16, 16, 3)).astype(np.uint8)
    xt = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(0)

    def aug(*a, **k):
        return tcu.device_augment(xt, gen, *a, **k).numpy()

    np.testing.assert_array_equal(aug(None, 1.0, None), x[:, :, ::-1, :])
    np.testing.assert_array_equal(aug(None, None, 1.0), x[:, ::-1, :, :])
    np.testing.assert_array_equal(aug(None, 0.0, 0.0), x)
    c = 16
    out = aug(c, None, None)
    assert out.shape == (6, c, c, 3)
    padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)))
    for i in range(6):
        assert any(np.array_equal(out[i], padded[i, y:y + c, xx:xx + c])
                   for y in range(9) for xx in range(9)), i
    assert not all(np.array_equal(out[i], out[0]) for i in range(6))

    small = torch.full((2, 8, 8, 3), 200, dtype=torch.uint8)
    out = tcu.device_augment(small, gen, 32, None, None).numpy()
    assert out.shape == (2, 32, 32, 3)
    assert (out == 200).any() and (out == 0).any()

    ramp = np.linspace(0, 248, 32, dtype=np.float32)
    imgs = np.broadcast_to(ramp[None, :, None, None],
                           (2, 32, 32, 3)).astype(np.uint8).copy()
    host = _augment(imgs.copy(), AugmentSpec(resize=16, crop=24),
                    np.random.RandomState(0))
    dev = tcu.device_augment(torch.from_numpy(imgs), gen, crop=24,
                             randhf=None, randvf=None, resize=16).numpy()
    assert dev.shape == (2, 24, 24, 3)
    assert np.abs(host.astype(int) - dev.astype(int)).max() <= 1


# ------------------------------------------------- path-backed COCO round --

def _write_pathbacked_rtv(tmp_path, name, n_img, cls, size=16, seed=0):
    """COCO-shaped set on disk: ``n_img`` PNGs, 5 captions each."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n_img):
        p = tmp_path / f"{name}_{i}.png"
        if not p.exists():
            Image.fromarray(rng.randint(0, 256, (size, size, 3))
                            .astype(np.uint8)).save(str(p))
        paths.append(str(p))
    n = n_img * 5
    texts = np.random.RandomState(seed + 100).randint(5, 120, (n, 8)) \
        .astype(np.int32)
    texts[:, 0] = 2
    return cls(name="Coco", task="rtv", modality="img+txt", num_classes=None,
               n=n, texts=texts, targets=texts,
               image_paths=[paths[i // 5] for i in range(n)],
               image_size=size, image_ids=np.arange(n) // 5,
               ann_ids=np.arange(n))


def _data(tmp_path, jax_side=False):
    cls = JTaskDataset if jax_side else TaskDataset
    train = _write_pathbacked_rtv(tmp_path, "tr", 6, cls, seed=0)
    test = _write_pathbacked_rtv(tmp_path, "te", 5, cls, seed=1)
    assert train.materialize_images() and test.materialize_images()
    out = (JFederatedData if jax_side else FederatedData)()
    out.server_eval["Coco"] = test
    shard = JClientShard if jax_side else ClientShard
    meta = JClientMeta if jax_side else ClientMeta
    for k, idx in enumerate((np.arange(0, 15), np.arange(15, 30))):
        out.client_shards.append(shard(dataset=train, indices=idx))
        out.client_meta[k] = meta(id=k, dataset="Coco", modality="img+txt",
                                  task="rtv", n_train=len(idx))
    return out


CFG = dict(exp_name="resident_test", seed=11, multi_task=True,
           datasets=["Coco", "Coco"], modalities=["img+txt", "img+txt"],
           Ks=[2], Cs=[1.0], K=2, R=1, E=1, B=8, eval_batch_size=16,
           optimizer="AdamW", lr=1e-3, criterion="CrossEntropyLoss",
           eval_type="global", model_name="mome_test_patch16_32", seq_len=8,
           split_type="iid", compute_dtype="float32", equal_sampled=True,
           train_chunk_steps=4, resize=32, vocab_size=120, dropout=0.0)


def _cfg(**kw):
    return tconfig.check_args(tconfig.ExperimentConfig(
        **{**CFG, **kw}, device="cpu"))


def _round(server):
    server.round = 1
    server.update()
    server.evaluate([])
    return server


@pytest.fixture(scope="module")
def coco_rounds(tmp_path_factory):
    """One round on the resident plane, the same on the host-fed plane
    (budget 0) and in the JAX server (resident), from the JAX server's
    initial weights."""
    tmp = tmp_path_factory.mktemp("coco")
    mp = pytest.MonkeyPatch()
    try:
        jserver = JFedAvgServer(jconfig.check_args(jconfig.ExperimentConfig(
            **CFG, use_pallas=False, mesh_shape=[1])), _data(tmp, True))
        init = {ds: jax.tree_util.tree_map(np.asarray, p)
                for ds, p in jserver.global_params.items()}
        out = {}
        for tag, budget in (("resident", 6 * 1024 ** 3), ("hostfed", 0)):
            mp.setenv("FEDCOLA_RESIDENT_BUDGET", str(budget))
            server = FedAvgServer(_cfg(), _data(tmp))
            for ds, p in init.items():
                server.global_params[ds] = convert.params_from_jax(
                    p, cfg=server.model_cfgs[ds])
            out[tag] = _round(server)
        mp.setenv("FEDCOLA_RESIDENT_BUDGET", str(6 * 1024 ** 3))
        out["jax"] = _round(jserver)
    finally:
        mp.undo()
    return out


def test_pathbacked_round_resident_matches_hostfed(coco_rounds):
    resident, hostfed = coco_rounds["resident"], coco_rounds["hostfed"]
    staged = resident._resident_cache["Coco"]
    assert staged is not None and "img_store" in staged
    assert staged["img_store"].shape[0] == 6          # unique images
    assert staged["img_row"].shape[0] == 30           # caption rows
    assert resident._resident_cache["eval:Coco"] is not None
    assert hostfed._resident_cache["Coco"] is None
    assert hostfed._resident_cache["eval:Coco"] is None
    for a, b in zip(tree_leaves(resident.global_params["Coco"]),
                    tree_leaves(hostfed.global_params["Coco"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    ev_r = resident.results[1]["server_evaluated_Coco"]
    ev_h = hostfed.results[1]["server_evaluated_Coco"]
    assert ev_r.keys() == ev_h.keys()
    for k in ev_r:
        assert ev_r[k] == pytest.approx(ev_h[k], abs=1e-6), k


def test_pathbacked_round_matches_jax_server(coco_rounds):
    tres = coco_rounds["resident"].results[1]
    jres = coco_rounds["jax"].results[1]
    tl = tres["clients_updated_summary"]["loss"]["avg"]
    jl = jres["clients_updated_summary"]["loss"]["avg"]
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    n_img, n_cap = 5, 25
    tr = tres["server_evaluated_Coco"]["Coco r@1sum"]
    jr = jres["server_evaluated_Coco"]["Coco r@1sum"]
    assert abs(tr - jr) <= 2.0 / n_img + 2.0 / n_cap + 1e-9, (tr, jr)


def test_unique_image_split_matches_joint_extraction(coco_rounds,
                                                     monkeypatch):
    """The image tower once per unique store row gives the features of the
    joint per-row forward (``FEDCOLA_EVAL_UNIQUE_IMAGES=0``)."""
    from fedcola_tpu_torch.eval import retrieval
    server = coco_rounds["resident"]
    spec = server._group_spec("Coco")
    test = server.data.server_eval["Coco"]
    args = (server.model_cfgs["Coco"], spec, server.global_params["Coco"],
            test, 4, np.random.RandomState(0),
            server._resident_eval_data("Coco", spec))
    split = retrieval.extract_features(*args)
    monkeypatch.setenv("FEDCOLA_EVAL_UNIQUE_IMAGES", "0")
    joint = retrieval.extract_features(*args[:5], np.random.RandomState(0),
                                       args[6])
    for a, b in zip(split[:2], joint[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    for a, b in zip(split[2:], joint[2:]):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------- budget and fallbacks --

def test_resident_budget_is_one_ledger(tmp_path, monkeypatch):
    """The budget bounds every staging together: once the train arrays
    take most of it, the eval set stays host-fed, and eval still runs."""
    server = FedAvgServer(_cfg(), _data(tmp_path))
    spec = server._group_spec("Coco")
    train = server._train_dataset("Coco")
    train_bytes = (train._image_store.nbytes
                   + np.asarray(train._image_row, np.int32).nbytes
                   + np.asarray(train.texts, np.int32).nbytes)
    monkeypatch.setenv("FEDCOLA_RESIDENT_BUDGET", str(train_bytes + 64))
    assert server._resident_data("Coco", spec) is not None
    assert server.resident_budget_left() <= 64
    assert server._resident_eval_data("Coco", spec) is None
    _round(server)
    assert "server_evaluated_Coco" in server.results[1]


def test_rotation_falls_back_to_host(tmp_path):
    """Rotation is a host-side transform: the group trains host-fed and
    its train set is never staged."""
    server = _round(FedAvgServer(_cfg(randrot=15), _data(tmp_path)))
    assert "Coco" not in server._resident_cache
    assert np.isfinite(
        server.results[1]["clients_updated_summary"]["loss"]["avg"])


def test_flip_augmented_run_stays_resident(tmp_path, monkeypatch):
    """Crop and flips run on the device: the group stays resident and its
    spec carries the augmentation."""
    monkeypatch.setenv("FEDCOLA_RESIDENT_BUDGET", str(6 * 1024 ** 3))
    server = _round(FedAvgServer(_cfg(randhf=0.5, randvf=0.5, crop=16),
                                 _data(tmp_path)))
    assert server._resident_cache["Coco"] is not None
    assert np.isfinite(
        server.results[1]["clients_updated_summary"]["loss"]["avg"])
    spec, aug, data = server._group_aug_plan("Coco",
                                             server._group_spec("Coco"))
    assert aug is None and data is not None and spec.device_aug
    assert (spec.aug_crop, spec.aug_randhf, spec.aug_randvf) == \
        (16, 0.5, 0.5)


def test_creamfl_public_set_over_budget_is_host_fed(tmp_path, monkeypatch):
    from test_torch_port_round import FEDCOLA
    flags = [{"fedavg": "creamfl"}.get(f, f) for f in FEDCOLA] + [
        "--num_pub_samples", "20", "--pub_batch_size", "8",
        "--device", "cpu", "--result_path", str(tmp_path / "r"),
        "--log_path", str(tmp_path / "l")]
    cfg = tconfig.parse_args(flags)
    server = create_server(cfg, tload(cfg, np.random.RandomState(cfg.seed)))
    monkeypatch.setenv("FEDCOLA_RESIDENT_BUDGET", "0")
    host = list(server._pub_batches())
    assert len(host) == 3 and server._pub_batches_dev is None
    assert server._resident_bytes == 0
    monkeypatch.setenv("FEDCOLA_RESIDENT_BUDGET", str(6 * 1024 ** 3))
    staged = list(server._pub_batches())
    assert server._pub_batches_dev is not None
    assert server._resident_bytes == server._pub_pinned_bytes > 0
    for a, b in zip(host, staged):
        for k in ("img", "txt", "didx", "valid"):
            assert a[k].equal(b[k]), k
    server.finalize()
    assert server._pub_batches_dev is None and server._resident_bytes == 0
