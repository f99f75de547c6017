"""Model configurations: ``<name>.json`` holds the sizes and precision as
they are run (with the source, what is assumed, what is reduced, and how
the seeded weights are shaped) and names its ``system``, the module
``<system>.py`` beside it that builds the program's state from them and
runs the program and the reference (a class ``System``). Configurations of
one model share its system."""
