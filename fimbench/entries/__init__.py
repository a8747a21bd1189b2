"""The doors of the program that a traffic mix can send its requests
through, one module each, found by the mix's ``entry`` name:
``fimbench/entries/<entry>.py`` defines

    build(rows, n_items, devices, config, traffic) -> entry

where ``entry(rows, min_sup)`` returns the program's answer (``.itemsets``,
``{sorted item-id tuple: support}``, and ``.stage_times_s``) and
``entry.n_items`` is the item universe. ``devices`` are the cell's
devices, one a chip; ``config`` and ``traffic`` are the configuration's
and the mix's files' objects.
Whatever the entry prepares in ``build`` is set-up."""
