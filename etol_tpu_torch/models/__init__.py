"""Vehicle dynamics, the problems built on them (single vehicles and the
deconflicted multi-vehicle fleet) and measured solver configs."""
