"""Training observability: stats capture → storage → web dashboard.

Reference parity: `deeplearning4j-ui-parent/` — `BaseStatsListener`
(ui-model), the `StatsStorage`/`StatsStorageRouter` API
(`deeplearning4j-core/.../api/storage/StatsStorage.java`), in-memory/file
storage impls, the Play UI server (`ui/play/PlayUIServer.java`) and the
remote stats router/receiver
(`core/.../impl/RemoteUIStatsStorageRouter.java` +
`ui/module/remote/RemoteReceiverModule.java`).

The port's `ui` exports the JAX package's names. The listener computes
on the model's device (`stats.py`); storage files, routes and record
types are the JAX package's, so either package's dashboard serves the
other's runs.
"""

from deeplearning4j_tpu_torch.ui.storage import (
    FileStatsStorage, InMemoryStatsStorage, Persistable, StatsStorage,
    StatsStorageEvent, StatsStorageRouter,
)
from deeplearning4j_tpu_torch.ui.stats import StatsListener
from deeplearning4j_tpu_torch.ui.server import RemoteStatsRouter, UIServer
from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram, ChartHorizontalBar, ChartLine, ChartScatter,
    ChartStackedArea, ChartTimeline, Component, ComponentDiv,
    ComponentTable, ComponentText, DecoratorAccordion, Style,
)

__all__ = [
    "FileStatsStorage", "InMemoryStatsStorage", "Persistable",
    "StatsStorage", "StatsStorageEvent", "StatsStorageRouter",
    "StatsListener", "RemoteStatsRouter", "UIServer",
    "Component", "ChartLine", "ChartHistogram", "ChartScatter",
    "ChartHorizontalBar", "ChartStackedArea", "ChartTimeline",
    "ComponentDiv", "ComponentTable", "ComponentText",
    "DecoratorAccordion", "Style",
]
