"""Traffic mixes: ``<mix>.json`` parameter files, each naming a driver
module of this package (``"driver"``), which runs the window's call."""
