"""How the program under test is called for each kind of configuration:
``systems/<system>.py`` (the configuration's ``system``) gives its
encoding, the dtype of the coefficients it is handed, and its commit."""
