"""As graph_replay_pct, in the camera cell."""

from metrics.graph_replay_pct import read  # noqa: F401
