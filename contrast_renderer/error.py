"""Error handling.

Mirrors the five semantic error cases of the reference
(src/error.rs:5-16) as Python exceptions, plus the shared floating point
comparison margin (src/error.rs:19).
"""


class ContrastError(Exception):
    """Base class for all renderer errors."""


class NumberOfStencilBitsIsUnsupported(ContrastError):
    """The choice of `clip_nesting_counter_bits` or `winding_counter_bits`
    is not supported (reference src/error.rs:7)."""


class ClipStackOverflow(ContrastError):
    """Rendering with more than 2**clip_nesting_counter_bits nested clip
    shapes (reference src/error.rs:9)."""


class TooManyNestedOpacityGroups(ContrastError):
    """Rendering with more than `alpha_layer_count` nested opacity groups
    (reference src/error.rs:11)."""


class TooManyDashIntervals(ContrastError):
    """Exceeded the maximum number of DashIntervals in DynamicStrokeOptions
    (reference src/error.rs:13)."""


class DynamicStrokeOptionsIndexOutOfBounds(ContrastError):
    """The passed DynamicStrokeOptions index is invalid
    (reference src/error.rs:15)."""


class FrameTooComplex(ContrastError):
    """The frame's per-tile command/draw tables outgrow int32 indexing
    (tiles × commands or tiles × draws past 2**31; a limit with no
    reference analogue — wgpu streams instance attributes from storage
    buffers, renderer.rs:462-466).  Split the frame, or instance
    repeated shapes so many (command, instance) draws share one
    command."""


class UnsupportedFontFormat(ContrastError):
    """The font carries no outline table this reader understands (the
    reference's ttf-parser returns FaceParsingError for malformed faces;
    this is our analogue for missing/unsupported outline formats —
    raised instead of failing obscurely deep in table parsing)."""


#: Used for floating point comparison (reference src/error.rs:19).
ERROR_MARGIN = 1e-4


def require_finite(value, name="value"):
    """Validation at API boundaries, standing in for the reference's
    SafeFloat finite assertion (src/safe_float.rs:46,114).

    Accepts scalars, nested sequences or numpy arrays; raises ValueError
    on NaN/Inf.  Returns the value unchanged for chaining.
    """
    import numpy as np

    arr = np.asarray(value)
    if arr.dtype.kind not in "fc":
        arr = arr.astype(np.float64)
    if not np.isfinite(arr).all():
        raise ValueError(f"{name} must be finite")
    return value
