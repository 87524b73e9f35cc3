"""Port parity of parallel/: the per-rank data shards and the sharded
inference and eval against the JAX package's parallel/ on the CPU.

The JAX side shards over the virtual CPU devices tests/conftest.py makes;
the port's mesh is two replicas on the CPU (a mesh may name one device
twice, which is how one card or the CPU runs the path). yololpn fused,
every parameter randomized from test_torch_evaler's seed, fp32; the
detections are held to that file's decode tolerance (rtol 1e-4, atol 1e-3
px / score), counts and class ids exactly.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_evaler import KW, jax_predict, models, synthetic  # noqa: F401  (fixtures)
from yololp_tpu.core.evaler import Evaler as JEvaler
from yololp_tpu.data.datasets import TrainValDataset as JDataset
from yololp_tpu.parallel import infer as jinfer
from yololp_tpu.parallel import mesh as jmesh
from yololp_tpu_torch.core.evaler import Evaler
from yololp_tpu_torch.data.datasets import TrainValDataset
from yololp_tpu_torch.parallel.infer import infer_mesh, make_sharded_infer_fn
from yololp_tpu_torch.parallel.mesh import shard_dataset_indices

torch.set_num_threads(2)

CPU_MESH = [torch.device("cpu")] * 2


def assert_dets_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 20:28], want[:, 20:28])
    np.testing.assert_allclose(got[:, :20], want[:, :20], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n, seed, epoch", [(10, 0, 0), (37, 3, 5)])
def test_shard_dataset_indices_slice_the_jax_permutation(n, seed, epoch):
    full = jmesh.shard_dataset_indices(n, seed, epoch)  # one JAX process: all of it
    np.testing.assert_array_equal(shard_dataset_indices(n, seed, epoch), full)
    for world in (2, 3):
        got = [shard_dataset_indices(n, seed, epoch, rank=r, world=world) for r in range(world)]
        for r, g in enumerate(got):
            np.testing.assert_array_equal(g, full[r::world])
        np.testing.assert_array_equal(np.sort(np.concatenate(got)), np.arange(n))


def test_process_shard_lists_the_jax_paths(tmp_path):
    from yololp_tpu_torch.data.synthetic import make_synthetic_dataset

    data = make_synthetic_dataset(str(tmp_path), n_train=7, n_val=0, img_size=64, seed=1)
    for world in (2, 3):
        lengths = set()
        for r in range(world):
            got = TrainValDataset(data["train"], img_size=64, process_shard=(r, world))
            want = JDataset(data["train"], img_size=64, process_shard=(r, world))
            assert got.img_paths == want.img_paths
            for g, w in zip(got.labels, want.labels):
                np.testing.assert_array_equal(g, w)
            lengths.add(len(got))
        assert lengths == {-(-7 // world)}  # padded by wrapping: equal steps on every rank


def test_sharded_infer_matches_jax(synthetic, models):  # noqa: F811
    data, _, _ = synthetic
    jmodel, jvars, tmodel = models
    imgs = np.stack([JDataset(data["val"], img_size=64)[i][0] for i in range(4)])
    kw = dict(conf_thres=KW["conf_thres"], iou_thres=KW["iou_thres"], max_det=KW["max_det"])
    mesh = jinfer.infer_mesh(2)
    assert mesh is not None and mesh.size == 2
    j_run, j_put = jinfer.make_sharded_infer_fn(jmodel, jvars, mesh, **kw)
    jdet, jvalid, jnum = (np.asarray(a) for a in j_run(j_put(imgs)))
    run, put = make_sharded_infer_fn(tmodel, CPU_MESH, **kw)
    for out in (run(imgs), run(put(imgs))):
        det, valid, num = (t.numpy() for t in out)
        np.testing.assert_array_equal(num, jnum)
        np.testing.assert_array_equal(valid, jvalid)
        assert num.sum() > 0
        for i in range(len(imgs)):
            assert_dets_close(det[i][valid[i]], jdet[i][jvalid[i]])
    with pytest.raises(ValueError, match="does not split"):
        run(imgs[:3])
    assert infer_mesh(2, "cpu") == CPU_MESH and infer_mesh(1, "cpu") is None


def test_predict_with_a_mesh_equals_the_plain_path_and_jax(synthetic, models):  # noqa: F811
    data, _, _ = synthetic
    jmodel, jvars, tmodel = models
    ev = Evaler(data, workers=0, half=False, device="cpu", **KW)
    loader, dataset = ev.init_data("val")
    assert len(dataset) == 6  # a tail batch of 2, padded to 4 by repeating its last frame
    plain_p, plain_t = ev.predict(ev.make_infer_fn(tmodel), loader)
    mesh_p, mesh_t = ev.predict(ev.make_infer_fn(tmodel, mesh=CPU_MESH), loader)
    _, (want_p, want_t) = jax_predict(data, jmodel, jvars)
    jev = JEvaler(data, workers=0, half=False, **KW)
    jloader, _ = jev.init_data("val")
    jmesh_p, jmesh_t = jev.predict(jev.make_infer_fn(jmodel, jvars, mesh=jinfer.infer_mesh(2)),
                                   jloader)
    assert sum(map(len, mesh_p)) > 0
    for targets in (plain_t, want_t, jmesh_t):
        for g, w in zip(mesh_t, targets):
            np.testing.assert_array_equal(g, w)
    for preds in (plain_p, want_p, jmesh_p):
        assert len(preds) == len(mesh_p) == 6
        for g, w in zip(mesh_p, preds):
            assert_dets_close(g, w)
    assert ev.eval(mesh_p, mesh_t) == ev.eval(plain_p, plain_t)
