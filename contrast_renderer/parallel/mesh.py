"""Sharded rendering across a device mesh.

Rendering is embarrassingly parallel over pixels once the geometry is
known, so the multi-chip strategy is: replicate the (small) geometry
tables to every device, shard the output image over a 1D (row bands) or
2D (row × column tiles) mesh, and give each device a *sub-rect-adjusted
projection*: rendering rect (by, bx) of an (ny, nx) grid at local size
(H/ny, W/nx) equals rendering the full frame with NDC remapped by
``x' = nx·x + (nx−1−2bx)·w`` and ``y' = ny·y + (1−ny+2by)·w`` — row
operations on the clip-space matrix, so the per-device executor is the
unmodified single-device frame program (prepare + raster kernel).

The only cross-device data movement is the sharded output layout (an
all-gather if the host requests the full image).  Every card reaches
every other at the same rate, so the mesh shape follows the frame's
split alone.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def band_adjusted_transform(transform, band, num_bands):
    """Remap a model→clip matrix so the full frame's row band `band`
    fills the whole viewport of a 1/num_bands-height render."""
    transform = jnp.asarray(transform, jnp.float32)
    n = jnp.float32(num_bands)
    offset = 1.0 - n + 2.0 * jnp.asarray(band, jnp.float32)
    row_y = n * transform[..., 1, :] + offset * transform[..., 3, :]
    return transform.at[..., 1, :].set(row_y)


def rect_adjusted_transform(transform, by, ny, bx, nx):
    """Remap a model→clip matrix so grid rect (by, bx) of an (ny, nx)
    split fills the whole viewport of a (H/ny, W/nx) render."""
    transform = band_adjusted_transform(transform, by, ny)
    fx = jnp.float32(nx)
    offset = fx - 1.0 - 2.0 * jnp.asarray(bx, jnp.float32)
    row_x = fx * transform[..., 0, :] + offset * transform[..., 3, :]
    return transform.at[..., 0, :].set(row_x)


def _sub_renderer(renderer, width, height, platform):
    from ..ops.coverage import interpret_for_platform
    from ..renderer import Renderer

    sub = Renderer(
        renderer.config,
        width,
        height,
        tile_size=renderer.tile_h,
        tile_capacity=renderer.tile_capacity,
        interpret=interpret_for_platform(platform),
        fill_batch=renderer.fill_batch,
        stroke_batch=renderer.stroke_batch,
    )
    # Inherit the outer renderer's (possibly pre-sized) binning
    # capacities: every overflow retry recompiles the sharded program.
    sub._global_capacity = renderer._global_capacity
    sub._tile_global_capacity = renderer._tile_global_capacity
    sub._clip_pool = renderer._clip_pool
    sub.blend_constant = renderer.blend_constant
    return sub


def _packed_pipeline(sub, commands, out_uint8=False):
    """Pack `commands` for the per-device executor.

    Returns ``(packed, keep_rows)`` where ``packed`` feeds the mapped
    pipeline and ``keep_rows`` re-indexes caller-supplied transform
    stacks from the public one-row-per-(command, instance) layout into
    the optimized draw layout (SAVE+SCALE pairs fuse away one row each,
    renderer._optimize_commands) — identical to FrameProgram's contract.
    ``out_uint8`` resolves each band to packed RGBA8 inside the kernel
    (see coverage.FrameSpec.out_uint8).
    """
    from dataclasses import replace

    from ..renderer import Renderer, _optimize_commands, _spec_paint

    sub._validate(commands)
    commands, keep_rows = _optimize_commands(commands)
    shapes, shape_index = sub._unique_shapes(commands)
    _, scene = sub._scene_arrays(shapes)
    ops = tuple(int(c.operation) for c in commands)
    cmd_shape = tuple(shape_index[id(c.shape)] for c in commands)
    inst = tuple(c.n_instances for c in commands)
    cmd_inst = inst if any(n != 1 for n in inst) else ()
    paints = tuple(_spec_paint(c.color) for c in commands)
    spec = sub._spec(
        ops, cmd_shape, cmd_inst, scene, paints, commands=commands
    )
    if out_uint8:
        spec = replace(spec, out_uint8=True)
    prepare, rasterize = sub._get_executors(spec)
    cmd_i, cmd_f = Renderer._pack_commands_runtime(
        commands, sub._blend_constant_arg()
    )
    desc_f, desc_i = Renderer._pack_descriptors(shapes)
    desc_static = np.ascontiguousarray(desc_i[:, [9, 8]])
    transform = Renderer._pack_transforms(commands)
    packed = (scene.arrays, prepare, rasterize, cmd_i, cmd_f, desc_f,
              desc_i, desc_static, transform,
              Renderer._pack_paints(commands))
    return packed, keep_rows


def _band_mapped(mesh, axis, num_bands, packed):
    """shard_map'd per-band frame step; returns (mapped, band indices).
    ``mapped(bands, transforms)`` → (band-sharded image, overflow)."""
    (scene_arrays, prepare, rasterize, cmd_i, cmd_f, desc_f, desc_i,
     desc_static, _transform, paint_model) = packed

    def per_band(band_index, transforms):
        adjusted = band_adjusted_transform(
            transforms, band_index[0], num_bands
        )
        prepared = prepare(
            *scene_arrays, adjusted, jnp.asarray(desc_static),
            None if paint_model is None else jnp.asarray(paint_model),
        )
        image = rasterize(prepared, cmd_i, cmd_f, desc_f, desc_i)
        return image, prepared.overflow[None]

    mapped = jax.shard_map(
        per_band,
        mesh=mesh,
        in_specs=(P(axis), None),
        out_specs=(P(axis, None, None), P(axis, None)),
        check_vma=False,
    )
    return mapped, jnp.arange(num_bands, dtype=jnp.int32)


def _rect_mapped(mesh, axes, ny, nx, packed):
    """shard_map'd per-rect frame step over a 2D tile grid; returns
    (mapped, row indices, column indices)."""
    ay, ax = axes
    (scene_arrays, prepare, rasterize, cmd_i, cmd_f, desc_f, desc_i,
     desc_static, _transform, paint_model) = packed

    def per_rect(by, bx, transforms):
        adjusted = rect_adjusted_transform(
            transforms, by[0], ny, bx[0], nx
        )
        prepared = prepare(
            *scene_arrays, adjusted, jnp.asarray(desc_static),
            None if paint_model is None else jnp.asarray(paint_model),
        )
        image = rasterize(prepared, cmd_i, cmd_f, desc_f, desc_i)
        return image, prepared.overflow[None, None]

    mapped = jax.shard_map(
        per_rect,
        mesh=mesh,
        in_specs=(P(ay), P(ax), None),
        out_specs=(P(ay, ax, None), P(ay, ax, None)),
        check_vma=False,
    )
    return (mapped, jnp.arange(ny, dtype=jnp.int32),
            jnp.arange(nx, dtype=jnp.int32))


def _run_with_growth(sub, commands, run_once, outer=None, to_host=True):
    """Run a sharded frame, growing binning capacities on overflow (the
    same contract as Renderer.render's retry loop).  ``run_once`` takes
    the packed pipeline and returns (image, overflow).  Grown
    capacities are written back to ``outer`` (the caller's full-frame
    renderer) so later builds — e.g. a ShardedFrameProgram settling
    capacities — see the converged values, not the pre-growth ones.
    ``to_host=False`` skips the full-frame host gather (a 4K f32 frame
    is ~132 MB) and returns the device array — the
    settle path only needs the (…, 4) overflow counters."""
    try:
        for _attempt in range(4):
            packed, _keep_rows = _packed_pipeline(sub, commands)
            image, overflow = run_once(packed)
            limits = (
                sub.tile_capacity,
                sub._global_capacity,
                sub._tile_global_capacity,
                sub._clip_pool,
            )
            worst = np.asarray(overflow).reshape(-1, 4).max(axis=0)
            sub._last_binning_worst = worst  # for shrink-to-fit
            if not sub._grow_capacities(worst, limits):
                return np.asarray(image) if to_host else image
        raise RuntimeError("sharded tile binning capacity did not converge")
    finally:
        if outer is not None:
            outer.tile_capacity = max(outer.tile_capacity,
                                      sub.tile_capacity)
            outer._global_capacity = max(outer._global_capacity,
                                         sub._global_capacity)
            outer._tile_global_capacity = max(outer._tile_global_capacity,
                                              sub._tile_global_capacity)
            outer._clip_pool = max(outer._clip_pool, sub._clip_pool)


def render_sharded(renderer, commands, mesh: Mesh, axis: str = "y"):
    """Render a frame with rows sharded over `mesh`'s `axis`
    (1D row bands).  `renderer` is sized to the FULL frame; its height
    must be divisible by the mesh axis size.  Returns the full
    (H, W, 4) image (gathered to host).  Binning capacities grown
    during the run are written back to `renderer`."""
    num_bands = mesh.shape[axis]
    assert renderer.height % num_bands == 0, "height must divide the mesh axis"
    band_height = renderer.height // num_bands
    platform = mesh.devices.reshape(-1)[0].platform
    sub = _sub_renderer(renderer, renderer.width, band_height, platform)

    def run_once(packed):
        mapped, bands = _band_mapped(mesh, axis, num_bands, packed)
        return mapped(bands, jnp.asarray(packed[8]))

    return _run_with_growth(sub, commands, run_once, outer=renderer)


def render_sharded_2d(
    renderer, commands, mesh: Mesh, axes: tuple = ("y", "x")
):
    """Render a frame sharded over a 2D device mesh: rows over
    ``axes[0]``, columns over ``axes[1]``.  Returns the full
    (H, W, 4) image.  Grown capacities are written back to `renderer`."""
    ay, ax = axes
    ny = mesh.shape[ay]
    nx = mesh.shape[ax]
    assert renderer.height % ny == 0 and renderer.width % nx == 0
    platform = mesh.devices.reshape(-1)[0].platform
    sub = _sub_renderer(renderer, renderer.width // nx,
                        renderer.height // ny, platform)

    def run_once(packed):
        mapped, bys, bxs = _rect_mapped(mesh, axes, ny, nx, packed)
        return mapped(bys, bxs, jnp.asarray(packed[8]))

    return _run_with_growth(sub, commands, run_once, outer=renderer)


class _ShardedProgramBase:
    """Shared machinery of the persistent sharded frame programs:
    build-time capacity settling on the program's OWN sub-renderer,
    caller-transform gathering through keep_rows, and FrameProgram's
    deferred-growth contract (async overflow copies consumed
    lag-bounded; on overflow the program self-heals by rebuilding with
    grown capacities instead of raising — an animated multi-chip scene
    that outgrows its binning buffers renders at most OVERFLOW_MAX_LAG
    under-populated frames, then recompiles)."""

    #: Frames an unconsumed overflow counter may age before the host
    #: blocks on it (see renderer.FrameProgram.OVERFLOW_MAX_LAG).
    OVERFLOW_MAX_LAG = 16

    def _settle_and_build(self):
        # Strict growth loop on self._sub: grown capacities must land on
        # the renderer _build reads, or a scene that overflows the
        # defaults could never converge (the r2 advisor finding: growing
        # a throwaway sub-renderer discards the growth).
        _run_with_growth(
            self._sub, self._commands, self._run_once, to_host=False
        )
        worst = getattr(self._sub, "_last_binning_worst", None)
        # Second settle probe at a rotated orientation: axis-aligned
        # scenes bin optimistically (trivial-accept lists no per-tile
        # entries for fully covered tiles), so the natural frame alone
        # under-sizes a program that will see camera motion (see
        # renderer._rotated_probe_commands).
        from ..renderer import _rotated_probe_commands

        _run_with_growth(
            self._sub, _rotated_probe_commands(self._commands),
            self._run_once, to_host=False,
        )
        probe = getattr(self._sub, "_last_binning_worst", None)
        if worst is not None and probe is not None:
            worst = np.maximum(worst, probe)
        # Shrink-to-fit (mirrors renderer.FrameProgram): the settle
        # frames' worst per-band counters size the program's binning
        # buffers at next-pow2(count · 1.5) instead of the renderer's
        # worst-case defaults; overflow past them regrows through
        # _sync's deferred rebuild.
        if worst is not None:
            from ..renderer import FIT_FLOORS, _fit_capacity

            sub = self._sub
            sub.tile_capacity = _fit_capacity(
                worst[0], FIT_FLOORS[0], sub.tile_capacity
            )
            sub._global_capacity = _fit_capacity(
                worst[1], FIT_FLOORS[1], sub._global_capacity
            )
            sub._tile_global_capacity = _fit_capacity(
                worst[2], FIT_FLOORS[2], sub._tile_global_capacity
            )
            sub._clip_pool = _fit_capacity(
                worst[3], FIT_FLOORS[3], sub._clip_pool
            )
        self._pending = []
        self._frame = 0
        self._build()

    def _build(self):
        packed, self._keep_rows = _packed_pipeline(
            self._sub, self._commands,
            out_uint8=getattr(self, "_uint8", False),
        )
        self._default_transform = packed[8]
        self._compile(packed)
        self._limits = (
            self._sub.tile_capacity,
            self._sub._global_capacity,
            self._sub._tile_global_capacity,
            self._sub._clip_pool,
        )

    def _sync(self):
        """Consume landed overflow counters (non-blocking while async
        copies are in flight, forced after OVERFLOW_MAX_LAG frames) and
        rebuild with grown capacities when any overflowed."""
        grew = False
        keep = []
        for overflow_arr, born in self._pending:
            ready = getattr(overflow_arr, "is_ready", lambda: True)()
            if ready or self._frame - born >= self.OVERFLOW_MAX_LAG:
                worst = np.asarray(overflow_arr).reshape(-1, 4).max(axis=0)
                grew |= self._sub._grow_capacities(worst, self._limits)
            else:
                keep.append((overflow_arr, born))
        self._pending = keep
        if grew:
            self._build()

    def __call__(self, transforms=None):
        """Render one frame; returns the sharded (H, W, 4) device
        array.  ``transforms``: (R, 4, 4), one row per (command,
        instance) draw in the ORIGINAL command layout — rows of
        fused-away SAVE covers are dropped internally, exactly as
        renderer.FrameProgram does."""
        if transforms is None:
            transforms = self._default_transform
        else:
            transforms = np.ascontiguousarray(
                transforms, np.float32
            ).reshape(-1, 4, 4)
            # Validate against the PUBLIC (pre-fusion) layout before the
            # keep_rows gather — a too-long stack would otherwise index
            # in range and silently render with misattributed rows.
            expected = sum(c.n_instances for c in self._commands)
            if transforms.shape[0] != expected:
                raise ValueError(
                    f"expected {expected} transform rows (one per "
                    f"command instance, pre-fusion), got "
                    f"{transforms.shape[0]}"
                )
            if self._keep_rows is not None:
                transforms = transforms[self._keep_rows]
        self._frame += 1
        self._sync()
        image, overflow = self._dispatch(jnp.asarray(transforms))
        try:
            overflow.copy_to_host_async()
        except AttributeError:
            pass
        self._pending.append((overflow, self._frame))
        return image


class ShardedFrameProgram(_ShardedProgramBase):
    """A persistent band-sharded frame step: the shard_map pipeline is
    traced and jitted ONCE, then each frame feeds a new (R, 4, 4)
    transform stack — the multi-chip analogue of renderer.FrameProgram
    (per-frame `render_sharded` re-traces the mapped pipeline every
    call, which dominates under camera animation)."""

    def __init__(self, renderer, commands, mesh: Mesh, axis: str = "y",
                 uint8_output: bool = False):
        num_bands = mesh.shape[axis]
        assert renderer.height % num_bands == 0, (
            "height must divide the mesh axis"
        )
        platform = mesh.devices.reshape(-1)[0].platform
        self._sub = _sub_renderer(
            renderer, renderer.width, renderer.height // num_bands, platform
        )
        self._mesh = mesh
        self._axis = axis
        self._num_bands = num_bands
        self._commands = list(commands)
        #: Per-band packed-RGBA8 resolve (see FrameProgram uint8_output).
        self._uint8 = bool(uint8_output)
        self._settle_and_build()

    def _run_once(self, packed):
        mapped, bands = _band_mapped(
            self._mesh, self._axis, self._num_bands, packed
        )
        return mapped(bands, jnp.asarray(packed[8]))

    def _compile(self, packed):
        mapped, self._bands = _band_mapped(
            self._mesh, self._axis, self._num_bands, packed
        )
        self._mapped = jax.jit(mapped)

    def _dispatch(self, transforms):
        return self._mapped(self._bands, transforms)


class ShardedFrameProgram2D(_ShardedProgramBase):
    """2D tile-grid variant of :class:`ShardedFrameProgram` (rows over
    ``axes[0]``, columns over ``axes[1]``)."""

    def __init__(
        self, renderer, commands, mesh: Mesh, axes: tuple = ("y", "x"),
        uint8_output: bool = False,
    ):
        ay, ax = axes
        ny, nx = mesh.shape[ay], mesh.shape[ax]
        assert renderer.height % ny == 0 and renderer.width % nx == 0
        platform = mesh.devices.reshape(-1)[0].platform
        self._sub = _sub_renderer(
            renderer, renderer.width // nx, renderer.height // ny, platform
        )
        self._mesh = mesh
        self._axes = axes
        self._ny, self._nx = ny, nx
        self._commands = list(commands)
        self._uint8 = bool(uint8_output)
        self._settle_and_build()

    def _run_once(self, packed):
        mapped, bys, bxs = _rect_mapped(
            self._mesh, self._axes, self._ny, self._nx, packed
        )
        return mapped(bys, bxs, jnp.asarray(packed[8]))

    def _compile(self, packed):
        mapped, self._bys, self._bxs = _rect_mapped(
            self._mesh, self._axes, self._ny, self._nx, packed
        )
        self._mapped = jax.jit(mapped)

    def _dispatch(self, transforms):
        return self._mapped(self._bys, self._bxs, transforms)
