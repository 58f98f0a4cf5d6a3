"""Plain NumPy reference of the decisions the benchmark checks.

A frozen rewrite of the scalar scheduler's semantics (first-fit-decreasing
over pod groups, cheapest-option launch, the provisioner's requirements,
zone spread by water filling), worked over the benchmark's own request
records and the frozen catalog JSON. It imports nothing of the program
under test and takes nothing the program made: options, allocatable,
overheads and prices are derived here from
portbench/data/fleet_catalog.json.
"""
