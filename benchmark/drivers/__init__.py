"""Traffic drivers: `<traffic>.json`'s `driver` names one of these
modules, whose `Driver` class sets up a cell, runs its window and checks
its outputs."""
