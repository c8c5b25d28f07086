"""Plain NumPy/SciPy/torch reference: inputs, the comparison, the control."""
