"""Campaign cells of the port: one module per paper table/figure
(counterpart of ``repro/experiments/cells``).

Importing this package registers every cell with
``repro_torch.experiments.registry``, so ``cells_in("paper")`` lists the
reference's whole ``paper`` campaign and ``cells_in("extended")`` its
``cnn`` cell (``cnn_fig5``, ROADMAP.md item 10.6).
"""

from repro_torch.experiments.cells import (baselines,  # noqa: F401
                                           bench_guard, cnn_fig5,
                                           distributed_replay,
                                           elastic_churn, fig4_staleness,
                                           fig5_lr_modulation,
                                           fig6_7_tradeoff, fig8_speedup,
                                           kernel_bench, ring_feasibility,
                                           sim_engine_bench, smoke_cells,
                                           table1_overlap, table2_mu_lambda,
                                           table3_4_summary,
                                           topology_scaling,
                                           train_while_serve)
