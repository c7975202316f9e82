"""As early_release_pct, in the camera cell."""

from metrics.early_release_pct import read  # noqa: F401
