"""Plain-XLA executor of a FrameSpec: the reference for the raster kernel.

It takes the same `PreparedFrame`, command tables and descriptors as
`coverage.make_rasterize` and returns the same image, written as plain
`jax.numpy`/`lax` over ALL tiles at once: the frame state is one array
per sample of shape (tiles, tile_h, tile_w), a scan walks the frame's
units in global draw order, and each stencil unit loops over entry
slots, gathering every tile's j-th entry of the command in one step.
A unit a tile does not list as active leaves that tile untouched, as the
kernel's per-tile walk does.

The per-sample predicates and the cover algebra are the kernel's own
helpers (coverage.fill_keep / stroke_keep / apply_cover — the
reference's shaders.wgsl and renderer.rs semantics); what this module
checks independently is the walk: tile geometry, local and big-triangle
entry ranges, batching and masking, stroke-before-fill order, hull-line
bits, state carry and the resolve layout.  Stroke classes vary per tile
here, so every class variant is evaluated and selected per tile, with
the where-chain cap predicate and the general dash search (a superset
of the single-interval case).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import coverage as cv


def make_reference_rasterize(spec: cv.FrameSpec):
    """`rasterize(prepared, cmd_i, cmd_f, desc_f, desc_i)` → image, the
    plain-XLA twin of `coverage.make_rasterize(spec)`."""
    draws = cv.draw_tables(spec)
    W, H = spec.width, spec.height
    th, tw = spec.tile_h, spec.tile_w
    ntx, nty, T = spec.ntx, spec.nty, spec.n_tiles
    K = spec.capacity
    KE = spec.capacity + spec.tile_global_capacity
    U = len(draws.unit_cmd)
    Hm = spec.h_max + 2
    S = spec.samples
    offsets = cv.SAMPLE_PATTERNS[S]
    has_clip, _, _, _ = cv._frame_features(spec)
    ops_by_branch = cv.cover_ops(spec)
    f32 = jnp.float32

    def rasterize(prepared, cmd_i, cmd_f, desc_f, desc_i):
        tiles = jnp.arange(T, dtype=jnp.int32)
        x0 = ((tiles % ntx) * tw).astype(f32)[:, None, None]
        y0 = ((tiles // ntx) * th).astype(f32)[:, None, None]
        col = jnp.arange(tw, dtype=f32)[None, None, :]
        row = jnp.arange(th, dtype=f32)[:, None][None]
        shape = (T, th, tw)
        px = [jnp.broadcast_to(x0 + col + float(ox), shape)
              for ox, _ in offsets]
        py = [jnp.broadcast_to(y0 + row + float(oy), shape)
              for _, oy in offsets]
        pxc = jnp.broadcast_to(x0 + col + 0.5, shape)
        pyc = jnp.broadcast_to(y0 + row + 0.5, shape)
        draw = cv.draw_table(spec, prepared, cmd_f)
        desc_f = jnp.asarray(desc_f)
        desc_i = jnp.asarray(desc_i)

        # active[t, u]: unit u is in tile t's active list.
        slots = jnp.arange(U)[None, :] < prepared.acount[:, None]
        active = jnp.zeros((T, U + 1), bool).at[
            tiles[:, None], prepared.aclist
        ].set(slots)[:, :U]

        def per_tile(v):
            return v[:, None, None]

        def entries(r):
            rf = prepared.tri_f[tiles, r]
            ri = prepared.tri_i[tiles, r]
            return cv._Row(
                lambda k: per_tile(rf[:, k]), lambda k: per_tile(ri[:, k])
            )

        def entry_loop(c, first, last, act, step, init):
            """Loop j over every tile's entries of command c in classes
            [first, last): local rows, then big-triangle rows."""
            lo = prepared.off[:, cv.N_CLASSES * c + first]
            nl = prepared.off[:, cv.N_CLASSES * c + last] - lo
            g_lo = prepared.g_off[:, cv.N_CLASSES * c + first]
            n = nl + prepared.g_off[:, cv.N_CLASSES * c + last] - g_lo
            n = jnp.where(act, n, 0)

            def body(j, carry):
                r = jnp.where(j < nl, lo + j, K + g_lo + (j - nl))
                return step(
                    carry, entries(jnp.clip(r, 0, KE - 1)),
                    per_tile(j < n),
                )

            return jax.lax.fori_loop(0, jnp.max(n), body, init)

        def stroke_cov(ent):
            grp = ent.i(cv.RI_GROUP)[:, 0, 0]

            def desc(k, is_int):
                return per_tile((desc_i if is_int else desc_f)[grp, k])

            variants = {
                (joint, dashed): cv.stroke_keep(
                    joint, 2 if dashed else 0, ent, desc, pxc, pyc,
                    offsets, cap_fn=cv._cap_mask,
                )
                for joint in (False, True) for dashed in (False, True)
            }
            code = ent.i(cv.RI_CLASS)
            joint = code >= cv.CLS_JOINT_SOLID
            dashed = (code != cv.CLS_LINE_SOLID) & (
                code != cv.CLS_JOINT_SOLID
            )
            return [
                jnp.where(
                    joint,
                    jnp.where(dashed, variants[True, True][s],
                              variants[True, False][s]),
                    jnp.where(dashed, variants[False, True][s],
                              variants[False, False][s]),
                )
                for s in range(S)
            ]

        def fill_cov(ent):
            code = ent.i(cv.RI_CLASS)
            variants = {
                cls_code: cv.fill_keep(cls_code, ent, pxc, pyc, offsets)
                for cls_code in cv.FILL_CLASSES
            }
            return [
                jnp.where(
                    code == cv.CLS_FILL_QUAD, variants[cv.CLS_FILL_QUAD][s],
                    jnp.where(
                        code == cv.CLS_FILL_CUBIC,
                        variants[cv.CLS_FILL_CUBIC][s],
                        variants[cv.CLS_FILL_SOLID][s],
                    ),
                )
                for s in range(S)
            ]

        def unit(st, xs):
            c, d, act = xs
            op = cmd_i[c, 0]
            depth = cmd_i[c, 1]
            layer = cmd_i[c, 2]
            pk = cmd_i[c, 3]
            if not has_clip:
                # No clip commands: the clip buffer is identically 0.
                act = act & (depth == 0)
            clip_ok = [cb == depth for cb in st.clip] if has_clip else None

            def clipped(s, m):
                return m & clip_ok[s] if clip_ok else m

            def stencil(st):
                wind = st.wind
                if spec.has_strokes:
                    # Strokes first (Equal-0 + IncrementWrap: the OR of
                    # the command's stroke entries sets winding 0 → 1).
                    def stroke_step(cov, ent, ok):
                        return tuple(
                            a | (b & ok) for a, b in zip(cov, stroke_cov(ent))
                        )

                    cov = entry_loop(
                        c, cv.CLS_LINE_SOLID, cv.CLS_FILL_SOLID, act,
                        stroke_step,
                        tuple(jnp.zeros(shape, bool) for _ in range(S)),
                    )
                    wind = tuple(
                        jnp.where(
                            clipped(s, cov[s] & (wind[s] == 0)), 1, wind[s]
                        )
                        for s in range(S)
                    )

                def fill_step(wind, ent, ok):
                    contrib = jnp.where(ok, ent.i(cv.RI_CONTRIB), 0)
                    keep = fill_cov(ent)
                    return tuple(
                        wind[s] + jnp.where(clipped(s, keep[s]), contrib, 0)
                        for s in range(S)
                    )

                wind = entry_loop(
                    c, cv.CLS_FILL_SOLID, cv.N_CLASSES, act, fill_step, wind
                )
                b = per_tile(jnp.where(act, prepared.bulk[:, c], 0))
                wind = tuple(
                    wind[s] + (jnp.where(clip_ok[s], b, 0) if clip_ok else b)
                    for s in range(S)
                )
                return st._replace(wind=wind)

            def cover(st):
                cl = prepared.cls[:, d]
                bits = prepared.hbits[:, d]
                base = jnp.broadcast_to(per_tile(act & (cl > 0)), shape)

                def hull_line(h, m):
                    a, b, e = (draw[d, cv.DRAW_HULL + 4 * h + k]
                               for k in range(3))
                    use = per_tile((cl == 1) & (((bits >> h) & 1) != 0))
                    return tuple(
                        m[s] & (~use | (a * px[s] + b * py[s] + e >= 0.0))
                        for s in range(S)
                    )

                in_hull = jax.lax.fori_loop(
                    0, Hm, hull_line, tuple(base for _ in range(S))
                )

                def branch(op_code):
                    if op_code is None:
                        return lambda st: st
                    return lambda st: cv.apply_cover(
                        spec, st, op_code, list(in_hull), clip_ok, depth,
                        layer, lambda k: draw[d, k], pk, px, py,
                    )

                return jax.lax.switch(
                    op - 1, [branch(o) for o in ops_by_branch], st
                )

            return jax.lax.cond(op == cv.OP_STENCIL, stencil, cover, st), None

        st, _ = jax.lax.scan(
            unit, cv._initial_state(spec, shape),
            (jnp.asarray(draws.unit_cmd), jnp.asarray(draws.unit_draw),
             active.T),
        )
        out = cv.resolve(spec, st.color)

        def detile(v):
            v = v.reshape(nty, ntx, th, tw).transpose(0, 2, 1, 3)
            return v.reshape(nty * th, ntx * tw)[:H, :W]

        if spec.out_uint8:
            return jax.lax.bitcast_convert_type(detile(out), jnp.uint8)
        return jnp.stack([detile(v) for v in out], axis=-1)

    return rasterize


_JITTED = {}


def render_reference(renderer, commands):
    """The plain executor's image of `commands` on `renderer`'s prepared
    frame (the same binning the kernel consumes): (H, W, 4) device
    array, float or packed uint8 as the renderer's frame spec says."""
    spec, args = renderer._prepare_frame(commands)
    fn = _JITTED.get(spec)
    if fn is None:
        if len(_JITTED) >= 8:
            _JITTED.pop(next(iter(_JITTED)))
        fn = _JITTED[spec] = jax.jit(make_reference_rasterize(spec))
    return fn(*args)


__all__ = ["make_reference_rasterize", "render_reference"]
