"""XML problem-configuration I/O.

A copy of ``etol_tpu/core/xml_io.py`` over the port's own ``VGP``,
``Track`` and ``VarType`` (host Python only). Parity with the reference's
libxml2-based ``loadConfigs``/``saveConfigs``
(TrajectoryOptimizer.cpp:787-1117 and :1119-1635; schema documented in
``src/docs/source/tutorials/vgp.rst`` and instantiated by
``resource/configs/{mip_2d_ex1,ocp_2d_ex1}.xml``). Same schema, stdlib
ElementTree instead of libxml2+XPath.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Union

from .problem import VGP, Track
from .types import VarType


def _fmt(v: float) -> str:
    """Round-trip-accurate float formatting for saveConfigs.

    The reference writes ~6 significant digits via ``std::to_string``
    (TrajectoryOptimizer.cpp:1119-1635); ``repr`` is the shortest string
    that round-trips the Python float (f64) exactly, so
    load(save(vgp)) == vgp for all float fields — including values that
    need more than 9 significant digits.
    """
    return repr(float(v))


def load_configs(path_or_string: Union[str, bytes], vgp: VGP = None) -> VGP:
    """Parse an <etol> XML document into a :class:`VGP`.

    Accepts a filesystem path or a raw XML string/bytes.
    """
    s = path_or_string
    if isinstance(s, bytes):
        root = ET.fromstring(s)
    elif isinstance(s, str) and s.lstrip().startswith("<"):
        root = ET.fromstring(s)
    else:
        root = ET.parse(s).getroot()
    if root.tag != "etol":
        raise ValueError(f"expected <etol> root, got <{root.tag}>")

    vgp = vgp if vgp is not None else VGP()
    vgp.nsteps = int(root.attrib["nsteps"])
    vgp.dt = float(root.attrib["dt"])

    states = root.find("states")
    if states is not None:
        vgp.x_rhorizon = int(states.attrib.get("rhorizon", 0))
        for st in states.findall("state"):
            vgp.xnames.append(st.attrib.get("name", f"x{len(vgp.x0)}"))
            vgp.xvartype.append(VarType.from_xml(st.attrib.get("vartype", "C")))
            vgp.xlower.append(float(st.attrib["lower"]))
            vgp.xupper.append(float(st.attrib["upper"]))
            vgp.x0.append(float(st.attrib["initial"]))
            vgp.xf.append(float(st.attrib["terminal"]))
            vgp.xtol.append(float(st.attrib["tolerance"]))

    controls = root.find("controls")
    if controls is not None:
        vgp.u_rhorizon = int(controls.attrib.get("rhorizon", 0))
        for ct in controls.findall("control"):
            vgp.unames.append(ct.attrib.get("name", f"u{len(vgp.ulower)}"))
            vgp.uvartype.append(VarType.from_xml(ct.attrib.get("vartype", "C")))
            vgp.ulower.append(float(ct.attrib["lower"]))
            vgp.uupper.append(float(ct.attrib["upper"]))

    exzones = root.find("exzones")
    if exzones is not None:
        for border in exzones.findall("border"):
            corners = [
                [float(c.attrib["x"]), float(c.attrib["y"]),
                 float(c.attrib.get("z", 0.0))]
                for c in border.findall("corner")
            ]
            vgp.add_exclusion_zone(corners)

    mexzones = root.find("mexzones")
    if mexzones is not None:
        for track in mexzones.findall("track"):
            radius = float(track.attrib["radius"])
            times, points = [], []
            for wp in track.findall("waypoint"):
                times.append(float(wp.attrib["t"]))
                points.append([float(d.text) for d in wp.findall("datum")])
            vgp.tracks.append(Track(radius, times, points))
    return vgp


def save_configs(vgp: VGP, path: str = None) -> str:
    """Serialize a :class:`VGP` back to the <etol> schema
    (saveConfigs parity, TrajectoryOptimizer.cpp:1119-1635). Returns the XML
    string; writes to ``path`` when given."""
    root = ET.Element(
        "etol", nsteps=str(vgp.nsteps), dt=_fmt(vgp.dt)
    )
    states = ET.SubElement(
        root, "states", nstates=str(vgp.nx), rhorizon=str(vgp.x_rhorizon)
    )
    for i in range(vgp.nx):
        name = vgp.xnames[i] if i < len(vgp.xnames) else f"x{i}"
        ET.SubElement(
            states, "state", name=name,
            vartype=vgp.xvartype[i].to_xml() if i < len(vgp.xvartype) else "C",
            lower=_fmt(vgp.xlower[i]), upper=_fmt(vgp.xupper[i]),
            initial=_fmt(vgp.x0[i]), terminal=_fmt(vgp.xf[i]),
            tolerance=_fmt(vgp.xtol[i]),
        )
    controls = ET.SubElement(
        root, "controls", ncontrols=str(vgp.nu), rhorizon=str(vgp.u_rhorizon)
    )
    for i in range(vgp.nu):
        name = vgp.unames[i] if i < len(vgp.unames) else f"u{i}"
        ET.SubElement(
            controls, "control", name=name,
            vartype=vgp.uvartype[i].to_xml() if i < len(vgp.uvartype) else "C",
            lower=_fmt(vgp.ulower[i]), upper=_fmt(vgp.uupper[i]),
        )
    exzones = ET.SubElement(root, "exzones", nzones=str(len(vgp.obstacles)))
    for i, poly in enumerate(vgp.obstacles):
        border = ET.SubElement(
            exzones, "border", name=f"exz{i}", ncorners=str(len(poly))
        )
        for c in poly:
            z = c[2] if len(c) > 2 else 0.0
            ET.SubElement(
                border, "corner", x=_fmt(c[0]), y=_fmt(c[1]),
                z=_fmt(z),
            )
    mexzones = ET.SubElement(root, "mexzones", nzones=str(len(vgp.tracks)))
    for i, trk in enumerate(vgp.tracks):
        track = ET.SubElement(
            mexzones, "track", name=f"mexz{i}",
            radius=_fmt(trk.radius), nwaypoints=str(len(trk.times)),
        )
        for j, (t, pt) in enumerate(zip(trk.times, trk.points)):
            wp = ET.SubElement(
                track, "waypoint", name=f"pt{j}", t=_fmt(t),
                ndatums=str(len(pt)),
            )
            for d in pt:
                ET.SubElement(wp, "datum").text = _fmt(d)
    ET.indent(root)
    xml = '<?xml version="1.0" encoding="UTF-8"?>\n' + ET.tostring(
        root, encoding="unicode"
    )
    if path is not None:
        with open(path, "w") as fh:
            fh.write(xml)
    return xml
