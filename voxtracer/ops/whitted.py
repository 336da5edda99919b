"""Legacy sorted-octant Whitted raytracer (reference ``shaders/basic.frag``).

The reference ships a second, older renderer: a fragment-shader Whitted
raytracer that walks the flat pointer octree front-to-back by sorting
each node's octants along the ray (``shaders/basic.frag:70-132``), shades
the first hit with one point-light shadow ray (``basic.frag:242-271``),
and is *dead code* — no pipeline binds it.  It has visibly bit-rotted:
it indexes children as ``nodes[node + octant]`` (``basic.frag:191``)
while the octree builder stores node *indices* (``src/context.rs:711-716``)
and the live shader reads ``nodes[8*node + octant]``
(``shaders/voxels.comp:175``).  This rebuild implements the same
algorithm against the real ABI so it actually renders; that one
deviation is deliberate and the only one.

JAX mapping: the per-pixel recursion becomes one ``lax.while_loop`` over
an explicit ``MAX_DEPTH``-frame stack held in small per-ray arrays,
``vmap``-ed over all pixels — XLA batches the loop (runs while any ray
is active, select-masking finished lanes) so the whole image is a single
fused device program; the octree is a read-only i32 buffer gathered per
step.  The GLSL's bitfield packing of sorted octants
(``basic.frag:53-68``) is replaced by plain ``(5,)`` arrays — the packing
only existed to dodge GPU register pressure.

World geometry note (derived, not stated in the reference): the shader's
``octant_center`` recursion (``basic.frag:43-46``) against the builder's
integer insertion (``src/context.rs:718-760``) places integer voxel ``p``
at the world cell ``[p/2, (p+1)/2)`` — the legacy renderer draws the
scene at half scale, and the header's ``child_size`` word is unused.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_DEPTH = 10  # basic.frag:3
# Safety fuse absent in the fragment shader (a rasterizer thread cannot
# hang the host; a device while_loop can).  Generous: a full traversal
# touches each stacked node at most count+1 <= 5 times.
MAX_ITERS = 4096

_F = jnp.float32
_I = jnp.int32


def _ray_cube(origin, inv_dir, center, half_size):
    """``ray_cube_intersection`` (basic.frag:24-41): slab test with the
    entry/exit planes picked by the sign of ``inv_dir``."""
    signum = jnp.sign(inv_dir)
    entries = (center - half_size * signum - origin) * inv_dir
    exits = (center + half_size * signum - origin) * inv_dir
    entry = jnp.max(entries)
    exit_ = jnp.min(exits)
    return (exit_ >= 0) & (entry < exit_), entry, exit_


def _octant_center(center, size, octant):
    """basic.frag:43-46 — child center offset by ±size/4 per axis bit."""
    bits = jnp.stack(
        [(octant >> 2) & 1, (octant >> 1) & 1, octant & 1]
    ).astype(_F)
    return center + 0.25 * size * jnp.sign(bits - 0.5)


def _octant_intersections(origin, inv_dir, center, size, entry, exit_):
    """``octant_intersections`` (basic.frag:70-132): the octants a ray
    crosses inside a node, front to back, with their entry times.

    Returns ``(octs (5,) i32, ents (5,) f32, count i32)``; slot ``count``
    of ``ents`` holds the node exit time, exactly like the GLSL's
    trailing ``entries[count] = exit``.
    """
    delta = center - origin
    pe = delta * inv_dir  # mid-plane crossing time per axis

    # Sort the three axes by crossing time with the GLSL's exact
    # comparison ladder (basic.frag:78-92) — replicating its tie and
    # NaN behavior (NaN compares false, leaving the identity order).
    c1 = pe[1] < pe[0]
    o0 = jnp.where(c1, 1, 0)
    o1 = jnp.where(c1, 0, 1)
    o2 = jnp.full((), 2, _I)
    c2 = pe[2] < jnp.take(pe, o1)
    c3 = pe[2] < jnp.take(pe, o0)
    o2_n = jnp.where(c2, o1, o2)
    o1_n = jnp.where(c2, jnp.where(c3, o0, 2), o1)
    o0_n = jnp.where(c2 & c3, 2, o0)
    order = jnp.stack([o0_n, o1_n, o2_n])
    sorted_pe = jnp.take(pe, order)

    # Starting octant: which side of each mid-plane the ray enters on
    # (basic.frag:96-99 — the !(delta>0) arm resolves the on-plane case
    # by travel direction).
    def _side(dlt, inv):
        return (dlt < 0) | (~(dlt > 0) & (inv < 0))

    octant = (
        jnp.where(_side(delta[0], inv_dir[0]), 4, 0)
        + jnp.where(_side(delta[1], inv_dir[1]), 2, 0)
        + jnp.where(_side(delta[2], inv_dir[2]), 1, 0)
    ).astype(_I)

    octs = jnp.zeros((5,), _I)
    ents = jnp.zeros((5,), _F)
    count = jnp.zeros((), _I)
    prev_time = entry

    for i in range(3):  # fixed trip count — unrolled (basic.frag:104-120)
        e_i = sorted_pe[i]
        skip = (e_i < 0) | (e_i >= exit_)  # crossing outside the node
        store = ~skip & (e_i >= entry)
        octs = jnp.where(
            store, jax.lax.dynamic_update_index_in_dim(octs, octant, count, 0), octs
        )
        ents = jnp.where(
            store, jax.lax.dynamic_update_index_in_dim(ents, prev_time, count, 0), ents
        )
        count = count + store.astype(_I)
        prev_time = jnp.where(store, e_i, prev_time)
        # continue skips the octant flip too (basic.frag:106,119)
        flip = jnp.right_shift(jnp.full((), 4, _I), order[i])
        octant = jnp.where(skip, octant, octant ^ flip)

    # The octant the ray exits through always lands (basic.frag:122-131).
    octs = jax.lax.dynamic_update_index_in_dim(octs, octant, count, 0)
    ents = jax.lax.dynamic_update_index_in_dim(ents, prev_time, count, 0)
    count = count + 1
    ents = jax.lax.dynamic_update_index_in_dim(ents, exit_, count, 0)
    return octs, ents, count


def cast_ray(nodes, root_center, root_size, origin, direction):
    """``cast_ray`` (basic.frag:142-240) for one ray.

    Returns ``(hit bool, time f32, color (3,) f32, normal (3,) f32)``.
    ``nodes`` is the flat i32 node buffer (header stripped); children are
    addressed ``nodes[8*node + octant]`` per the builder's ABI.
    """
    inv_dir = 1.0 / direction
    intersect, root_entry, root_exit = _ray_cube(
        origin, inv_dir, root_center, 0.5 * root_size
    )
    r_octs, r_ents, r_count = _octant_intersections(
        origin, inv_dir, root_center, root_size, root_entry, root_exit
    )

    # Explicit stack of MAX_DEPTH frames (basic.frag:134-146).
    st_node = jnp.zeros((MAX_DEPTH,), _I)
    st_stage = jnp.zeros((MAX_DEPTH,), _I)
    st_center = jnp.zeros((MAX_DEPTH, 3), _F).at[0].set(root_center)
    st_size = jnp.zeros((MAX_DEPTH,), _F).at[0].set(root_size)
    st_octs = jnp.zeros((MAX_DEPTH, 5), _I).at[0].set(r_octs)
    st_ents = jnp.zeros((MAX_DEPTH, 5), _F).at[0].set(r_ents)
    st_count = jnp.zeros((MAX_DEPTH,), _I).at[0].set(r_count)
    sp = jnp.where(intersect, 1, 0).astype(_I)

    def cond(state):
        sp, hit, fuel = state[0], state[8], state[12]
        return (sp > 0) & ~hit & (fuel > 0)

    def body(state):
        (sp, st_node, st_stage, st_center, st_size, st_octs, st_ents,
         st_count, hit, time, value, nplane, fuel) = state
        c = sp - 1
        i = st_stage[c]
        st_stage = st_stage.at[c].add(1)

        pop = i >= st_count[c]  # node exhausted (basic.frag:181-185)
        node = st_node[c]
        octant = st_octs[c, i]
        val = nodes[8 * node + octant]

        is_leaf = ~pop & (val < 0)
        is_child = ~pop & (val > 0)

        child_center = _octant_center(st_center[c], st_size[c], octant)

        # Leaf: record hit time + face normal plane (basic.frag:194-204).
        t_hit = st_ents[c, i]
        point = origin + direction * t_hit
        dists = jnp.abs(point - child_center)
        max_d = jnp.max(dists)
        npl = jnp.where(
            dists[0] == max_d, 0, jnp.where(dists[1] == max_d, 1, 2)
        ).astype(_I)

        # Child: intersect its octants and push (basic.frag:209-224).
        child_size = 0.5 * st_size[c]
        c_octs, c_ents, c_count = _octant_intersections(
            origin, inv_dir, child_center, child_size,
            st_ents[c, i], st_ents[c, i + 1],
        )
        push = is_child & (sp < MAX_DEPTH)
        st_node = jnp.where(push, st_node.at[sp].set(val), st_node)
        st_stage = jnp.where(push, st_stage.at[sp].set(0), st_stage)
        st_center = jnp.where(push, st_center.at[sp].set(child_center), st_center)
        st_size = jnp.where(push, st_size.at[sp].set(child_size), st_size)
        st_octs = jnp.where(push, st_octs.at[sp].set(c_octs), st_octs)
        st_ents = jnp.where(push, st_ents.at[sp].set(c_ents), st_ents)
        st_count = jnp.where(push, st_count.at[sp].set(c_count), st_count)

        sp = sp + jnp.where(push, 1, 0) - jnp.where(pop, 1, 0)
        hit = hit | is_leaf
        time = jnp.where(is_leaf, t_hit, time)
        value = jnp.where(is_leaf, val, value)
        nplane = jnp.where(is_leaf, npl, nplane)
        return (sp, st_node, st_stage, st_center, st_size, st_octs,
                st_ents, st_count, hit, time, value, nplane, fuel - 1)

    state = (sp, st_node, st_stage, st_center, st_size, st_octs, st_ents,
             st_count, jnp.zeros((), bool), jnp.zeros((), _F),
             jnp.zeros((), _I), jnp.zeros((), _I),
             jnp.full((), MAX_ITERS, _I))
    state = jax.lax.while_loop(cond, body, state)
    hit, time, value, nplane = state[8], state[9], state[10], state[11]

    # Unpack the leaf color (basic.frag:231-234); arithmetic >> on the
    # negative i32 then mask, same as the GLSL.
    color = (
        jnp.stack([(value >> 16) & 0xFF, (value >> 8) & 0xFF, value & 0xFF])
        .astype(_F) / 255.0
    )
    axis_hot = jax.nn.one_hot(nplane, 3, dtype=_F)
    normal = -jnp.sign(jnp.sum(direction * axis_hot)) * axis_hot
    return hit, time, color, normal


def _shade(nodes, root_center, root_size, origin, direction, light_pos,
           light_brightness):
    """``main`` (basic.frag:242-271): first hit + one point-light shadow
    ray; miss shows ``abs(dir)``."""
    direction = direction / jnp.linalg.norm(direction)
    hit, time, color, normal = cast_ray(
        nodes, root_center, root_size, origin, direction
    )

    hit_point = origin + direction * (0.99999 * time)
    to_hit = hit_point - light_pos
    light_distance = jnp.linalg.norm(to_hit)
    light_dir = to_hit / light_distance
    obstructed, shadow_time, _, _ = cast_ray(
        nodes, root_center, root_size, hit_point, -light_dir
    )
    shadow = obstructed & (shadow_time <= light_distance)

    diffuse = (
        0.8 * light_brightness
        * jnp.maximum(0.0, jnp.sum(-light_dir * normal))
        / light_distance**2
    )
    brightness = 0.2 + jnp.where(shadow, 0.3 * diffuse, diffuse)
    return jnp.where(hit, color * brightness, jnp.abs(direction))


@jax.jit
def _shade_chunk(nodes, root_center, root_size, origin, dirs, light_pos,
                 light_brightness):
    shade = lambda d: _shade(
        nodes, root_center, root_size, origin, d, light_pos,
        light_brightness,
    )
    return jax.vmap(shade)(dirs)


def render_whitted(octree, origin, right, up, forward, light_pos,
                   light_brightness, *, width, height, chunk=8192):
    """Render the legacy Whitted view: one ray per pixel over the flat
    octree blob (header + nodes, as built by :func:`scene.octree.build_octree`).

    ``right/up/forward`` is the pixel-space basis from
    ``Camera.axis_scaled`` — ``ray(px, py) = px*right - py*up + forward``,
    the same convention as the live renderer (the reference feeds
    basic.frag NDC ``frag_coord`` instead, basic.frag:243-248; identical
    up to the basis scaling).  Returns an (H, W, 3) f32 image.

    Rays dispatch in fixed ``chunk``-size blocks through one cached jit
    program: the while-loop runs until the SLOWEST ray in a block
    retires, so bounded blocks keep each device program short (and one
    resolution-independent compile) instead of holding a whole frame
    hostage to its worst ray.
    """
    header = jax.lax.bitcast_convert_type(jnp.asarray(octree[:5]), _F)
    root_center = header[:3]
    root_size = header[3]
    nodes = jnp.asarray(octree[5:])

    px = jnp.arange(width, dtype=_F) + 0.5
    py = jnp.arange(height, dtype=_F) + 0.5
    dirs = (
        px[None, :, None] * right[None, None, :]
        - py[:, None, None] * up[None, None, :]
        + forward[None, None, :]
    ).reshape(-1, 3)

    n = dirs.shape[0]
    pad = (-n) % chunk
    if pad:
        # Padding rays reuse the last real direction (they trace real
        # geometry, so they can't out-iterate the frame's worst ray).
        dirs = jnp.concatenate([dirs, jnp.broadcast_to(dirs[-1], (pad, 3))])
    blocks = [
        _shade_chunk(nodes, root_center, root_size, origin,
                     dirs[i : i + chunk], light_pos, light_brightness)
        for i in range(0, n + pad, chunk)
    ]
    return jnp.concatenate(blocks)[:n].reshape(height, width, 3)


def render_scene(voxels, camera, width, height,
                 light_pos=(0.4, -0.4, 0.02), light_brightness=0.05):
    """Convenience wrapper: voxel list -> legacy Whitted frame.

    Light defaults are the reference's legacy-era bindings
    (``src/context.rs:944-947``).  NOTE the half-scale world: voxel ``p``
    occupies ``[p/2, (p+1)/2)`` (see module docstring), so cameras framed
    for the live renderer sit twice as far out here.
    """
    from ..scene.octree import build_octree

    octree = jnp.asarray(build_octree(voxels))
    right, up, forward = camera.axis_scaled(width, height)
    return render_whitted(
        octree,
        jnp.asarray(camera.position, _F),
        jnp.asarray(right, _F),
        jnp.asarray(up, _F),
        jnp.asarray(forward, _F),
        jnp.asarray(np.asarray(light_pos, np.float32)),
        jnp.float32(light_brightness),
        width=width,
        height=height,
    )
