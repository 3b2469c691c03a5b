"""Port parity: XML problem I/O. Both shipped configs load field by field
as the JAX package loads them, from a path, a string and bytes; a save and
a load give the problem back; the port's copies of the configs are the
reference's bytes; and the VGP's console dump and param registry match."""
import dataclasses
import pathlib

import numpy as np
import pytest

from etol_tpu.core import problem as jproblem
from etol_tpu.core import types as jtypes
from etol_tpu.core import xml_io as jxml
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.core import types as ttypes
from etol_tpu_torch.core import xml_io as txml

REPO = pathlib.Path(__file__).resolve().parent.parent
JCONF = REPO / "etol_tpu" / "configs"
TCONF = REPO / "etol_tpu_torch" / "configs"
NAMES = ("ocp_2d_ex1.xml", "mip_2d_ex1.xml")


def _same_vgp(tv, jv):
    """Every field of the two host-side VGPs, one by one."""
    tf = {f.name for f in dataclasses.fields(tv)}
    jf = {f.name for f in dataclasses.fields(jv)}
    assert tf == jf
    for name in sorted(tf):
        a, b = getattr(tv, name), getattr(jv, name)
        if name == "obstacles":
            assert len(a) == len(b)
            for pa, pb in zip(a, b):
                np.testing.assert_array_equal(pa, pb)
        elif name == "tracks":
            assert [dataclasses.astuple(t) for t in a] == [
                dataclasses.astuple(t) for t in b]
        elif name in ("xvartype", "uvartype"):
            assert [int(v) for v in a] == [int(v) for v in b]
        elif name == "params":
            assert {k: dataclasses.astuple(v) for k, v in a.items()} == {
                k: dataclasses.astuple(v) for k, v in b.items()}
        else:
            assert a == b, name


@pytest.mark.parametrize("name", NAMES)
def test_shipped_config_bytes_equal(name):
    assert (TCONF / name).read_bytes() == (JCONF / name).read_bytes()


@pytest.mark.parametrize("name", NAMES)
def test_load_matches_field_by_field(name):
    tv = txml.load_configs(str(TCONF / name))
    jv = jxml.load_configs(str(JCONF / name))
    _same_vgp(tv, jv)
    assert isinstance(tv, tproblem.VGP) and isinstance(
        tv.tracks[0], tproblem.Track)
    assert isinstance(tv.xvartype[0], ttypes.VarType)
    assert dataclasses.asdict(tv.dims()) == dataclasses.asdict(jv.dims())
    assert tv.horizon == jv.horizon


def test_mip_config_has_rhorizon_and_four_controls():
    tv = txml.load_configs(str(TCONF / "mip_2d_ex1.xml"))
    assert (tv.nsteps, tv.nx, tv.nu, tv.x_rhorizon) == (16, 2, 4, 1)
    ov = txml.load_configs(str(TCONF / "ocp_2d_ex1.xml"))
    assert (ov.nsteps, ov.nx, ov.nu) == (32, 2, 2)
    assert len(ov.tracks) == 2 and len(ov.obstacles) > 0


@pytest.mark.parametrize("kind", ["str", "bytes"])
def test_load_from_raw_document(kind):
    raw = (TCONF / "ocp_2d_ex1.xml").read_bytes()
    doc = raw if kind == "bytes" else raw.decode()
    _same_vgp(txml.load_configs(doc),
              jxml.load_configs(str(JCONF / "ocp_2d_ex1.xml")))


def test_wrong_root_raises():
    with pytest.raises(ValueError, match="<etol>"):
        txml.load_configs("<notetol nsteps='1' dt='1'/>")


@pytest.mark.parametrize("name", NAMES)
def test_save_load_round_trip(name, tmp_path):
    tv = txml.load_configs(str(TCONF / name))
    # a value that needs more than 9 significant digits survives
    tv.xtol[0] = 0.1234567890123
    path = tmp_path / "saved.xml"
    xml = txml.save_configs(tv, str(path))
    assert path.read_text() == xml
    _same_vgp(txml.load_configs(str(path)), tv)
    # the two packages write the same document
    jv = jxml.load_configs(str(JCONF / name))
    jv.xtol[0] = 0.1234567890123
    assert jxml.save_configs(jv) == xml
    assert txml._fmt(0.1) == jxml._fmt(0.1) == "0.1"


def test_print_configs_and_add_params(capsys):
    tv = txml.load_configs(str(TCONF / "mip_2d_ex1.xml"))
    jv = jxml.load_configs(str(JCONF / "mip_2d_ex1.xml"))
    tv.add_params({"s": ttypes.ParamConfig(
        ttypes.VarType.CONTINUOUS, 0.0, 10.0, 0.0, 8.0)})
    jv.add_params({"s": jtypes.ParamConfig(
        jtypes.VarType.CONTINUOUS, 0.0, 10.0, 0.0, 8.0)})
    assert tv.print_configs() == jv.print_configs()
    assert "Params:" in capsys.readouterr().out
    assert tv.dims().n_params == 1 and tv.dims().node_width == 7
    assert isinstance(jv, jproblem.VGP)
