"""One module a kind of configuration: ``Cell(cfg, mix, seed, device)``
sets the cell up, ``window(seconds, span)`` runs the measured window,
``end_to_end()`` gives its end-to-end metrics, ``check()`` the numbers
compared with the plain reference, ``notes()`` lines for the log."""
