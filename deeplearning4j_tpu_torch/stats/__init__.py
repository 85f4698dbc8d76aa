"""Training statistics and the dashboard (counterpart of
deeplearning4j_tpu/stats/): StatsReport, the storages, StatsListener,
render_html and UIServer."""

from deeplearning4j_tpu_torch.stats.report import (  # noqa: F401
    Histogram,
    StatsReport,
)
from deeplearning4j_tpu_torch.stats.storage import (  # noqa: F401
    FileStatsStorage,
    InMemoryStatsStorage,
    RemoteStatsStorageRouter,
    StatsStorage,
)
from deeplearning4j_tpu_torch.stats.listener import StatsListener  # noqa: F401
from deeplearning4j_tpu_torch.stats.dashboard import (  # noqa: F401
    UIServer,
    collect_conv_activations,
    collect_network_flow,
    embedding_scatter,
    render_html,
    telemetry_lines,
)
