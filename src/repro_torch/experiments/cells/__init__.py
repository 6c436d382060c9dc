"""Campaign cells of the port: one module per paper table/figure
(counterpart of ``repro/experiments/cells``).

Importing this package registers every cell ported so far with
``repro_torch.experiments.registry``, so ``cells_in("paper")`` lists
those; the rest of the reference's cells wait for ROADMAP.md queue 1
item 6.
"""

from repro_torch.experiments.cells import (elastic_churn,  # noqa: F401
                                           topology_scaling,
                                           train_while_serve)
