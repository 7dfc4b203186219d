"""The plain detector reference: frozen copies of the port's plain code."""
