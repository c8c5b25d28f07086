"""The paper's comparison harness on the port (``comparisons``) and its
table generator (``comparisons_to_table``)."""
