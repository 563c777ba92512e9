"""One module per kind of system under test; a configuration's
``system`` key names the module here, which has ``run_cell``."""
