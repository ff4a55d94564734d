"""The paper's primary contribution in PyTorch: the PTT/PJTT physical data
structures and the SOM/ORM/OJM operators, plus the planner and the eager
executor (``repro_torch.core.executor``) that run RML documents."""
