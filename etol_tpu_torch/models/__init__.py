"""Vehicle dynamics, problem builders and measured solver configs."""
