"""Campaign cells of the port: one module per paper table/figure
(counterpart of ``repro/experiments/cells``).

Importing this package registers every cell ported so far with
``repro_torch.experiments.registry``, so ``cells_in("paper")`` lists
those.  Not ported yet (ROADMAP.md item 6): ``ring_feasibility``,
``distributed_replay`` (item 8) and ``cnn_fig5`` (item 10).
"""

from repro_torch.experiments.cells import (baselines,  # noqa: F401
                                           bench_guard, elastic_churn,
                                           fig4_staleness,
                                           fig5_lr_modulation,
                                           fig6_7_tradeoff, fig8_speedup,
                                           kernel_bench, sim_engine_bench,
                                           smoke_cells, table1_overlap,
                                           table2_mu_lambda,
                                           table3_4_summary,
                                           topology_scaling,
                                           train_while_serve)
