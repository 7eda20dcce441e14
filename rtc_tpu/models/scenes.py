"""The shipped scenes (reference: src/main.rs:84-397) + benchmark configs.

Each builder returns (World, camera_factory) where camera_factory(width)
reproduces the reference CLI contract: height = width / 2, fov 0.785
(src/main.rs:77, 329).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Tuple

import numpy as np

from ..ops import matrices as M
from ..ops import transforms as X
from ..render.camera import Camera
from ..scene.materials import (
    Material,
    checkers_pattern,
    gradient_pattern,
    stripe_pattern,
)
from ..scene.shapes import cube, cylinder, group, plane, sphere
from ..scene.world import PointLight, World, default_world
from ..io.obj import Parser

PI = math.pi

ASSETS = os.path.join(os.path.dirname(__file__), "..", "..", "assets")


def _cam(width: int, fr, to, fov: float = 0.785) -> Camera:
    cam = Camera(width, width // 2, fov)
    cam.set_transform(np.asarray(X.view_transform(fr, to, [0, 1, 0]), dtype=np.float64))
    return cam


def _mm(*ms):
    out = np.asarray(ms[0], dtype=np.float64)
    for m in ms[1:]:
        out = out @ np.asarray(m, dtype=np.float64)
    return out


# --- hexagon (reference: src/main.rs:84-146) --------------------------------

def hexagon_world() -> World:
    def corner():
        return sphere(transform=_mm(X.translation(0, 0, -1), X.scaling(0.25, 0.25, 0.25)))

    def edge():
        return cylinder(
            0.0, 1.0, True,
            transform=_mm(
                X.translation(0, 0, -1),
                X.rotation_y(-PI / 6),
                X.rotation_z(-PI / 2),
                X.scaling(0.25, 1.0, 0.25),
            ),
        )

    def side():
        return group([corner(), edge()])

    sides = []
    for i in range(6):
        s = side()
        s.set_transform(X.rotation_y(i * PI / 3))
        sides.append(s)
    hexagon = group(sides)
    hexagon.set_transform(X.scaling(2.5, 2.5, 2.5))

    return World(objects=[hexagon], light=PointLight((0.0, 6.9, -5.0), (1.0, 1.0, 0.9)))


def hexagon(width: int = 400):
    return hexagon_world(), _cam(width, [8, 6, -8], [0, 0, 0])


# --- table (reference: src/main.rs:151-323) ---------------------------------

def table_world() -> World:
    objects = []

    floor_ceiling = cube(transform=_mm(X.scaling(20, 7, 20), X.translation(0, 1, 0.1)))
    pat = checkers_pattern((0, 0, 0), (0.25, 0.25, 0.25)).set_transform(
        X.scaling(0.07, 0.07, 0.07))
    floor_ceiling.material = Material(
        pattern=pat, ambient=0.25, diffuse=0.7, specular=0.9, shininess=300.0,
        reflective=0.1)
    objects.append(floor_ceiling)

    walls = cube(transform=X.scaling(10, 10, 10))
    pat = checkers_pattern(
        (0.4863, 0.3765, 0.2941), (0.3725, 0.2902, 0.2275)
    ).set_transform(X.scaling(0.05, 20.0, 0.05))
    walls.material = Material(pattern=pat, ambient=0.1, diffuse=0.7, specular=0.9,
                              shininess=300.0, reflective=0.1)
    objects.append(walls)

    table_top = cube(transform=_mm(X.translation(0, 3.1, 0), X.scaling(3, 0.1, 2)))
    pat = stripe_pattern((0.5529, 0.4235, 0.3255), (0.6588, 0.5098, 0.4000)).set_transform(
        _mm(X.scaling(0.05, 0.05, 0.05), X.rotation_y(0.1)))
    table_top.material = Material(pattern=pat, ambient=0.1, diffuse=0.7, specular=0.9,
                                  shininess=300.0, reflective=0.2)
    objects.append(table_top)

    for sx, sz in ((2.7, -1.7), (2.7, 1.7), (-2.7, -1.7), (-2.7, 1.7)):
        leg = cube(transform=_mm(X.translation(sx, 1.5, sz), X.scaling(0.1, 1.5, 0.1)))
        leg.material = Material(color=(0.5529, 0.4235, 0.3255), ambient=0.2, diffuse=0.7)
        objects.append(leg)

    glass_cube = cube(transform=_mm(
        X.translation(0, 3.45001, 0), X.rotation_y(0.2), X.scaling(0.25, 0.25, 0.25)))
    glass_cube.material = Material(
        color=(1, 1, 0.8), ambient=0.0, diffuse=0.3, specular=0.9, shininess=300.0,
        reflective=0.1, transparency=0.7, refractive_index=1.5)
    objects.append(glass_cube)

    little = [
        ((1.0, 3.35, -0.9), -0.4, (0.15, 0.15, 0.15), (1.0, 0.5, 0.5), 0.6, 0.4),
        ((-1.5, 3.27, 0.3), 0.4, (0.15, 0.7, 0.15), (1.0, 1.0, 0.5), None, None),
        ((0.0, 3.25, 1.0), 0.4, (0.2, 0.05, 0.05), (0.5, 1.0, 0.5), None, None),
        ((-0.6, 3.4, -1.0), 0.8, (0.05, 0.2, 0.05), (0.5, 0.5, 1.0), None, None),
        ((2.0, 3.4, 1.0), 0.8, (0.05, 0.2, 0.05), (0.5, 1.0, 1.0), None, None),
    ]
    for pos, ry, scale, color, refl, diff in little:
        c = cube(transform=_mm(X.translation(*pos), X.rotation_y(ry), X.scaling(*scale)))
        kw = dict(color=color)
        if refl is not None:
            kw["reflective"] = refl
        if diff is not None:
            kw["diffuse"] = diff
        c.material = Material(**kw)
        objects.append(c)

    frames = [
        ((-10.0, 4.0, 1.0), (0.05, 1.0, 1.0), (0.7098, 0.2471, 0.2196)),
        ((-10.0, 3.4, 2.7), (0.05, 0.4, 0.4), (0.2667, 0.2706, 0.6902)),
        ((-10.0, 4.6, 2.7), (0.05, 0.4, 0.4), (0.3098, 0.5961, 0.3098)),
    ]
    for pos, scale, color in frames:
        f = cube(transform=_mm(X.translation(*pos), X.scaling(*scale)))
        f.material = Material(color=color, diffuse=0.6)
        objects.append(f)

    mirror_frame = cube(transform=_mm(X.translation(-2, 3.5, 9.95), X.scaling(5, 1.5, 0.05)))
    mirror_frame.material = Material(color=(0.3882, 0.2627, 0.1882), diffuse=0.7)
    objects.append(mirror_frame)

    mirror = cube(transform=_mm(X.translation(-2, 3.5, 9.95), X.scaling(4.8, 1.4, 0.06)))
    mirror.material = Material(color=(0, 0, 0), diffuse=0.0, ambient=0.0, specular=0.0,
                               shininess=300.0, reflective=1.0)
    objects.append(mirror)

    return World(objects=objects, light=PointLight((0.0, 6.9, -5.0), (1.0, 1.0, 0.9)))


def table(width: int = 400):
    return table_world(), _cam(width, [8, 6, -8], [0, 3, 0])


# --- cow (reference: src/main.rs:328-363) -----------------------------------

def cow_world() -> World:
    cow = Parser.from_obj_file(os.path.join(ASSETS, "cow-nonormals.obj")).obj_to_group()
    cow.set_transform(_mm(X.translation(0, 3.5, 0), X.scaling(0.5, 0.5, 0.5)))
    cow.set_material(Material(color=(1, 1, 1), ambient=0.1, diffuse=0.7, specular=0.9,
                              shininess=300.0, reflective=0.2))
    return World(objects=[cow], light=PointLight((0.0, 6.9, -5.0), (1.0, 1.0, 0.9)))


def cow(width: int = 400):
    return cow_world(), _cam(width, [8, 6, -8], [0, 3, 0])


# --- teapot (reference: src/main.rs:368-397) --------------------------------

def teapot_world() -> World:
    teapot_shape = Parser.from_obj_file(os.path.join(ASSETS, "teapot.obj")).obj_to_group()
    teapot_shape.set_transform(X.translation(0, -1.5, 0))
    teapot_shape.set_material(
        Material(pattern=gradient_pattern((0, 1, 0), (0, 0, 1))))
    return World(objects=[teapot_shape], light=PointLight((0.0, 6.9, -5.0), (1.0, 1.0, 0.9)))


def teapot(width: int = 400):
    return teapot_world(), _cam(width, [0, 4, -12], [0, 0, 0])


def teapot_smooth_world() -> World:
    """Teapot with computed per-vertex normals and Phong-interpolated
    (smooth-triangle) shading — the capability the reference stubs out
    (src/obj_file.rs:295-335) and BASELINE config 5 requires."""
    t = Parser.from_obj_file(os.path.join(ASSETS, "teapot.obj")).obj_to_group(
        smooth=True)
    t.set_transform(X.translation(0, -1.5, 0))
    t.set_material(Material(pattern=gradient_pattern((0, 1, 0), (0, 0, 1))))
    return World(objects=[t], light=PointLight((0.0, 6.9, -5.0), (1.0, 1.0, 0.9)))


def teapot_smooth(width: int = 400):
    return teapot_smooth_world(), _cam(width, [0, 4, -12], [0, 0, 0])


def glass_teapot_world() -> World:
    """Refractive-mesh stress scene: a glass teapot over a checkered floor —
    exercises the mesh n1/n2 container walk (closed transparent meshes act as
    refractive containers exactly like the reference's shape-agnostic
    containers walk, src/intersection.rs:29-62)."""
    t = Parser.from_obj_file(os.path.join(ASSETS, "teapot.obj")).obj_to_group(
        smooth=True)
    t.set_transform(X.translation(0, -1.0, 0))
    t.set_material(Material(
        color=(0.05, 0.08, 0.05), ambient=0.02, diffuse=0.15, specular=0.9,
        shininess=300.0, reflective=0.1, transparency=0.9,
        refractive_index=1.5))
    floor = plane(
        transform=X.translation(0, -1.0, 0),
        material=Material(
            # 4-unit cells stay resolvable at golden widths (sub-pixel
            # checkers would turn the f32-vs-f64 comparison into parity
            # noise); y-shifted so the plane doesn't sit on a parity
            # knife-edge (cf. three_spheres_world)
            pattern=checkers_pattern(
                (0.85, 0.85, 0.85), (0.15, 0.15, 0.15)
            ).set_transform(_mm(X.scaling(4.0, 4.0, 4.0),
                                X.translation(0.0, 0.5, 0.0))),
            specular=0.0, reflective=0.05))
    return World(objects=[floor, t],
                 light=PointLight((0.0, 6.9, -5.0), (1.0, 1.0, 0.9)))


def glass_teapot(width: int = 400):
    return glass_teapot_world(), _cam(width, [0, 4, -12], [0, 0, 0])


def _obj_scene(asset: str, transform, material: Material, cam_from, cam_to,
               width: int, smooth: bool = False):
    shape = Parser.from_obj_file(os.path.join(ASSETS, asset)).obj_to_group(
        smooth=smooth)
    shape.set_transform(transform)
    shape.set_material(material)
    w = World(objects=[shape], light=PointLight((0.0, 6.9, -5.0), (1.0, 1.0, 0.9)))
    return w, _cam(width, cam_from, cam_to)


def pumpkin(width: int = 400):
    """pumpkin_tall_10k.obj — the largest shipped asset (10k triangles)."""
    # the mesh is centered around ~(-3, 1, -110) at radius ~40: recenter+scale
    return _obj_scene(
        "pumpkin_tall_10k.obj",
        _mm(X.translation(0, 3.0, 0), X.scaling(0.06, 0.06, 0.06),
            X.translation(2.6, -0.9, 110.0)),
        Material(color=(0.95, 0.55, 0.12), ambient=0.1, diffuse=0.8,
                 specular=0.4, shininess=50.0),
        [8, 6, -8], [0, 3, 0], width, smooth=True)


def cow_herd_smooth_world(nx: int = 10, nz: int = 9) -> World:
    """cow_herd with SMOOTH (Phong-interpolated) shading: every cow carries
    per-vertex normals, so every hit blends corner normals (the
    smooth-triangle capability the reference stubs at
    src/intersection.rs:381-386) over the 523k-triangle world table."""
    return cow_herd_world(nx, nz, smooth=True)


def cow_herd_smooth(width: int = 400):
    return cow_herd_smooth_world(), _cam(width, [0, 14, -24], [0, 3, 10])


def cow_herd_world(nx: int = 10, nz: int = 9, smooth: bool = False) -> World:
    """Large-scene stress: an nx x nz grid of cow meshes (default 90 cows =
    522,360 triangles), ~90x the cow's triangle table: the traversal
    kernel's box culling carries it, and it is the prim-sharding ("scenes
    too big to replicate") exercise of SURVEY §2."""
    parser = Parser.from_obj_file(os.path.join(ASSETS, "cow-nonormals.obj"))
    cows = []
    for i in range(nx):
        for j in range(nz):
            c = parser.obj_to_group(smooth=smooth)
            # non-uniform spacing/heading so AABBs don't align degenerately
            c.set_transform(_mm(
                X.translation(3.0 * (i - (nx - 1) / 2.0), 3.5,
                              3.0 * j + 0.7 * ((i * 7 + j * 3) % 5)),
                X.rotation_y(0.6 * ((i * 5 + j) % 7)),
                X.scaling(0.5, 0.5, 0.5)))
            c.set_material(Material(
                color=(0.9, 0.85 - 0.04 * (j % 3), 0.8 - 0.05 * (i % 4)),
                ambient=0.1, diffuse=0.8, specular=0.3, shininess=50.0))
            cows.append(c)
    return World(objects=cows, light=PointLight((0.0, 30.0, -20.0),
                                                (1.0, 1.0, 0.9)))


def cow_herd(width: int = 400):
    return cow_herd_world(), _cam(width, [0, 14, -24], [0, 3, 10])


def teddy(width: int = 400):
    """teddy.obj with smooth shading."""
    return _obj_scene(
        "teddy.obj",
        _mm(X.translation(0, 3.0, 0), X.scaling(0.15, 0.15, 0.15),
            X.rotation_y(PI)),
        Material(color=(0.6, 0.4, 0.2), diffuse=0.8, specular=0.3),
        [8, 6, -8], [0, 3, 0], width, smooth=True)


# --- benchmark extras (BASELINE.json configs) --------------------------------

def single_sphere_world() -> World:
    s = sphere(material=Material(color=(1.0, 0.2, 1.0)))
    return World(objects=[s], light=PointLight((-10, 10, -10), (1, 1, 1)))


def single_sphere(width: int = 256):
    w = single_sphere_world()
    cam = Camera(width, width, PI / 3)
    cam.set_transform(
        np.asarray(X.view_transform([0, 0, -3], [0, 0, 0], [0, 1, 0]), dtype=np.float64))
    return w, cam


def three_spheres_world() -> World:
    """Multi-sphere world with floor plane, shadows, patterns (BASELINE config 2)."""
    # checkers shifted off y=0 so the floor doesn't sit on a parity knife-edge
    floor = plane(material=Material(
        color=(1, 0.9, 0.9), specular=0.0,
        pattern=checkers_pattern((1, 0.9, 0.9), (0.2, 0.2, 0.25)).set_transform(
            X.translation(0.0, 0.5, 0.0))))
    middle = sphere(transform=X.translation(-0.5, 1, 0.5), material=Material(
        color=(0.1, 1, 0.5), diffuse=0.7, specular=0.3,
        pattern=stripe_pattern((0.1, 1, 0.5), (0.9, 0.2, 0.2))))
    right = sphere(transform=_mm(X.translation(1.5, 0.5, -0.5), X.scaling(0.5, 0.5, 0.5)),
                   material=Material(color=(0.5, 1, 0.1), diffuse=0.7, specular=0.3))
    left = sphere(transform=_mm(X.translation(-1.5, 0.33, -0.75), X.scaling(0.33, 0.33, 0.33)),
                  material=Material(color=(1, 0.8, 0.1), diffuse=0.7, specular=0.3))
    return World(objects=[floor, middle, right, left],
                 light=PointLight((-10, 10, -10), (1, 1, 1)))


def three_spheres(width: int = 400):
    return three_spheres_world(), _cam(width, [0, 1.5, -5], [0, 1, 0], fov=PI / 3)


def glass_spheres_world() -> World:
    """Reflective+refractive stress scene (BASELINE config 3)."""
    from ..scene.shapes import glass_sphere

    floor = plane(material=Material(
        pattern=checkers_pattern((0.8, 0.8, 0.8), (0.2, 0.2, 0.2)).set_transform(
            X.translation(0.0, 0.5, 0.0)),
        reflective=0.2))
    outer = glass_sphere(transform=X.translation(0, 1, 0))
    outer.material.reflective = 0.9
    outer.material.color = (0.1, 0.1, 0.1)
    outer.material.diffuse = 0.1
    inner = sphere(transform=_mm(X.translation(0, 1, 0), X.scaling(0.5, 0.5, 0.5)),
                   material=Material(transparency=1.0, refractive_index=1.0,
                                     diffuse=0.1, color=(0.1, 0.1, 0.1)))
    return World(objects=[floor, outer, inner],
                 light=PointLight((-10, 10, -10), (1, 1, 1)))


def glass_spheres(width: int = 400):
    return glass_spheres_world(), _cam(width, [0, 1.5, -5], [0, 1, 0], fov=PI / 3)


def default_world_scene(width: int = 400):
    w = default_world()
    cam = Camera(width, width, PI / 2)
    cam.set_transform(
        np.asarray(X.view_transform([0, 0, -5], [0, 0, 0], [0, 1, 0]), dtype=np.float64))
    return w, cam


REGISTRY: Dict[str, Callable[[int], Tuple[World, Camera]]] = {
    "hexagon": hexagon,
    "table": table,
    "cow": cow,
    "teapot": teapot,
    "teapot_smooth": teapot_smooth,
    "glass_teapot": glass_teapot,
    "pumpkin": pumpkin,
    "teddy": teddy,
    "cow_herd": cow_herd,
    "cow_herd_smooth": cow_herd_smooth,
    "single_sphere": single_sphere,
    "three_spheres": three_spheres,
    "glass_spheres": glass_spheres,
    "default_world": default_world_scene,
}
