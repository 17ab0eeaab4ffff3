"""PyTorch port vs the JAX package: the sharding rules and the meshes.

``repro_torch.sharding`` gives JAX's spec (a tuple per dimension of a
mesh axis name, a tuple of names, or None) for every parameter of all ten
archs at full width on the (4, 8), (4, 16), (16, 16) and (2, 16, 16)
meshes (``tests/test_sharding.py``'s ``fake_mesh`` on both sides), and
for every cache and batch leaf on the two production meshes, where the
JAX side runs on real 512-device host meshes in one subprocess (it sets
``XLA_FLAGS`` itself and returns JSON).  ``placements`` maps a spec to
DTensor placements; ``make_production_mesh`` builds the meshes inside a
fake world and fails as ``jax.make_mesh`` fails on one device, and so
does the training driver's ``--mesh prod``.  Every comparison is exact.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.models import transformer as jax_T
from repro.models.nn import Spec as JaxSpec
from repro import sharding as jax_shd
from repro_torch import sharding as shd
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES
from repro_torch.models.registry import ARCHS, get_config, input_specs
from test_sharding import fake_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [((4, 8), ("data", "model")), ((4, 16), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


def _flat(tree, path=()):
    """{path: leaf} of a nested dictionary."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {path: tree}


def _norm(spec) -> list:
    """A spec as JSON holds it: tuples of names as lists."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_equal_jax(arch):
    from repro.models.registry import get_config as jax_config

    jcfg, cfg = jax_config(arch), get_config(arch)
    jspecs = _flat(jax_T.model_specs(jcfg))
    for shape, axes in MESHES:
        m = fake_mesh(shape, axes)
        got = _flat(shd.param_shardings(T.model_specs(cfg), m))
        assert set(got) == set(jspecs)
        for path, s in jspecs.items():
            assert isinstance(s, JaxSpec)
            want = tuple(jax_shd.spec_for(s.shape, s.axes, m))
            assert got[path].spec == want, (arch, shape, path)
            assert got[path].mesh is m


@pytest.mark.parametrize("arch", list(ARCHS))
def test_logical_axes_equal_jax(arch):
    from repro.models.registry import get_config as jax_config

    assert T.param_logical_axes(get_config(arch)) == \
        jax_T.param_logical_axes(jax_config(arch))


def test_rules_and_dp_axes():
    assert shd.LOGICAL_RULES == jax_shd.LOGICAL_RULES
    for shape, axes in MESHES:
        m = fake_mesh(shape, axes)
        assert shd.dp_axes(m) == jax_shd.dp_axes(m)
    m = fake_mesh((4, 16))
    assert shd.spec_for((1024, 8, 128), ("embed", "kv_heads", "head"), m) \
        == (None, None, None)
    assert shd.replicated(m).spec == ()


_JAX_SIDE = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
from repro import sharding as shd
from repro.launch.mesh import make_production_mesh
from repro.models import transformer as T
from repro.models.config import SHAPES
from repro.models.registry import ARCHS, get_config, input_specs

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

out = {"cache": {}, "batch": {}, "batch_one": {}}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    mname = "2x16x16" if mp else "16x16"
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname in ("decode_32k", "long_500k"):
            shp = SHAPES[sname]
            cache = jax.eval_shape(lambda: T.init_cache(
                cfg, shp.global_batch, shp.seq_len, jnp.bfloat16))
            cs = shd.cache_shardings(cfg, mesh, cache,
                                     seq_parallel=sname == "long_500k")
            out["cache"][f"{arch}|{sname}|{mname}"] = {
                k: spec(v) for k, v in cs.items()}
        for sname, shp in SHAPES.items():
            bs = shd.batch_shardings(mesh, input_specs(cfg, shp))
            out["batch"][f"{arch}|{sname}|{mname}"] = {
                k: spec(v) for k, v in bs.items()}
    for b in (1, 2, 16, 32, 128, 256, 512, 48):
        for nd in (1, 2, 3):
            out["batch_one"][f"{b}|{nd}|{mname}"] = spec(
                shd.batch_sharding(mesh, b, nd))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _JAX_SIDE], check=True,
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=600)
    return json.loads(res.stdout.strip().splitlines()[-1])


def _prod(mp: bool):
    return fake_mesh((2, 16, 16), ("pod", "data", "model")) if mp \
        else fake_mesh((16, 16), ("data", "model"))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_and_batch_specs_equal_jax(jax_side, arch):
    cfg = get_config(arch)
    for mp in (False, True):
        m = _prod(mp)
        mname = "2x16x16" if mp else "16x16"
        for sname in ("decode_32k", "long_500k"):
            shp = SHAPES[sname]
            cache = D._abstract_cache(cfg, shp.global_batch, shp.seq_len,
                                      torch.bfloat16)
            got = shd.cache_shardings(cfg, m, cache,
                                      seq_parallel=sname == "long_500k")
            want = jax_side["cache"][f"{arch}|{sname}|{mname}"]
            assert {k: _norm(v.spec) for k, v in got.items()} == want
        for sname, shp in SHAPES.items():
            got = shd.batch_shardings(m, input_specs(cfg, shp))
            want = jax_side["batch"][f"{arch}|{sname}|{mname}"]
            assert {k: _norm(v.spec) for k, v in got.items()} == want


def test_batch_sharding_equal_jax(jax_side):
    for key, want in jax_side["batch_one"].items():
        b, nd, mname = key.split("|")
        got = shd.batch_sharding(_prod(mname == "2x16x16"), int(b), int(nd))
        assert _norm(got.spec) == want, key


def test_placements():
    m = fake_mesh((2, 4, 8), ("pod", "data", "model"))
    assert shd.placements((("pod", "data"), None, "model"), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shd.placements((None, "data"), m) == \
        [Replicate(), Shard(1), Replicate()]
    assert shd.placements((), m) == [Replicate()] * 3
    with pytest.raises(ValueError):
        shd.placements((("data", "pod"),), m)
    one = fake_mesh((1, 1))
    assert shd.placements(("data", "model"), one) == [Replicate()] * 2


def test_production_meshes_in_a_fake_world():
    with mesh_lib.fake_world(512):
        for mp, shape, names in ((False, (16, 16), ("data", "model")),
                                 (True, (2, 16, 16), ("pod", "data", "model"))):
            m = mesh_lib.make_production_mesh(multi_pod=mp, device="cpu")
            assert tuple(m.shape) == shape
            assert m.mesh_dim_names == names
            assert shd.axis_sizes(m) == dict(zip(names, shape))
        host = mesh_lib.make_host_mesh(device="cpu")
        assert tuple(host.shape) == (1, 1)
    assert not torch.distributed.is_initialized()
    with mesh_lib.fake_world(16):
        with pytest.raises(ValueError, match="Number of devices 16 must be "
                           r">= the product of mesh_shape \(16, 16\)"):
            mesh_lib.make_production_mesh()
        with pytest.raises(RuntimeError):
            with mesh_lib.fake_world(2):
                pass
    assert not torch.distributed.is_initialized()


def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_meshes_fail_as_jax_does_on_one_device():
    from repro.launch import mesh as jax_mesh

    for mp in (False, True):
        want = _jax_error(lambda: jax_mesh.make_production_mesh(multi_pod=mp))
        got = _jax_error(lambda: mesh_lib.make_production_mesh(multi_pod=mp))
        assert got == want


def test_train_mesh_prod_fails_as_jax_does(monkeypatch):
    from repro.launch import train as jax_train
    from repro_torch.launch import train

    for flag in ("prod", "multipod"):
        monkeypatch.setattr(sys, "argv", ["train", "--mesh", flag])
        want = _jax_error(jax_train.main)
        got = _jax_error(lambda: train.main(["--mesh", flag, "--device",
                                             "cpu"]))
        assert got == want
