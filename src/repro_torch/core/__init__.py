"""Distance-metric-learning core: the Eq. 4 objective and its pieces
(``dml``), the loss registry (``losses``), kNN / k-means evaluation
(``eval_tasks``), the parameter server (``ps``) and the paper's Fig. 4
baselines: Xing et al. 2002 (``xing2002``), ITML (``itml``) and KISS
(``kiss``)."""
