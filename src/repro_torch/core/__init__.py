"""Distance-metric-learning core: the Eq. 4 objective and its pieces
(``dml``), the loss registry (``losses``), kNN / k-means evaluation
(``eval_tasks``) and the parameter server (``ps``)."""
