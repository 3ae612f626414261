"""mrt.utils.struct: every pytree class of the render path.

Children flatten in field order and unflatten to an equal object;
static fields live in the treedef (a new value is a new program);
`.replace` returns a copy and instances are frozen.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mrt.core.camera import Camera
from mrt.geometry.bvh import FlatBVH
from mrt.geometry.hit import Hits
from mrt.geometry.instance import TLAS, FlatPart
from mrt.geometry.scene import Scene
from mrt.geometry.spheres import Spheres
from mrt.geometry.triangles import Triangles
from mrt.geometry.volumes import MeshVolume, VolumeSpheres
from mrt.geometry.voxels import VoxelGrid
from mrt.materials.background import (CubeMap, SkyBackground, SkySphere,
                                      SolidBackground)
from mrt.materials.lights import LightTable
from mrt.materials.table import MaterialTable
from mrt.runtime.film import Film
from mrt.textures.atlas import TextureAtlas
from mrt.utils import struct

CLASSES = [Camera, FlatBVH, Hits, TLAS, FlatPart, Scene, Spheres,
           Triangles, MeshVolume, VolumeSpheres, VoxelGrid, CubeMap,
           SkyBackground, SkySphere, SolidBackground, LightTable,
           MaterialTable, Film, TextureAtlas]


def _split(cls):
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f)
    return data, meta


def _instance(cls):
    data, meta = _split(cls)
    kw = {f.name: jnp.full((2,), float(i)) for i, f in enumerate(data)}
    kw.update({f.name: f.default for f in meta})
    return cls(**kw)


def _ids(classes):
    return [c.__name__ for c in classes]


@pytest.mark.parametrize("cls", CLASSES, ids=_ids(CLASSES))
def test_flatten_unflatten(cls):
    obj = _instance(cls)
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    data, _ = _split(cls)
    assert len(leaves) == len(data)
    for leaf, f in zip(leaves, data):   # field order
        np.testing.assert_array_equal(leaf, getattr(obj, f.name))
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is cls
    for f in dataclasses.fields(cls):
        np.testing.assert_array_equal(getattr(back, f.name),
                                      getattr(obj, f.name))


@pytest.mark.parametrize("cls", CLASSES, ids=_ids(CLASSES))
def test_replace_and_frozen(cls):
    obj = _instance(cls)
    data, _ = _split(cls)
    if not data:                                # e.g. SkyBackground
        assert obj.replace() == obj
        name = "anything"
    else:
        name = data[0].name
        new = obj.replace(**{name: jnp.arange(3.0)})
        np.testing.assert_array_equal(getattr(new, name), [0.0, 1.0, 2.0])
        assert getattr(obj, name).shape == (2,)  # original untouched
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, name, None)


STATIC = [c for c in CLASSES if _split(c)[1]]


@pytest.mark.parametrize("cls", STATIC, ids=_ids(STATIC))
def test_static_fields(cls):
    obj = _instance(cls)
    f = _split(cls)[1][0]
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    other = {bool: lambda v: not v, int: lambda v: v + 1,
             str: lambda v: v + "x"}[type(f.default)](f.default)
    obj2 = obj.replace(**{f.name: other})
    leaves2, treedef2 = jax.tree_util.tree_flatten(obj2)
    assert len(leaves2) == len(leaves)          # not a child
    assert treedef2 != treedef                  # part of the treedef
    traces = []

    @jax.jit
    def fn(x):
        traces.append(getattr(x, f.name))
        return jax.tree_util.tree_leaves(x)[0] * 2

    fn(obj)
    fn(obj)
    fn(obj2)
    assert traces == [f.default, other]         # one program per value


def test_field_metadata():
    f = struct.field(pytree_node=False, default=3)
    assert f.metadata["pytree_node"] is False and f.default == 3
    assert struct.field().metadata["pytree_node"] is True
