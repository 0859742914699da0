from .bandwidth import cross_rack_table, fig3_rows
from .reliability import MTTDLModel, table1_rows, table2_rows

__all__ = [
    "cross_rack_table",
    "fig3_rows",
    "MTTDLModel",
    "table1_rows",
    "table2_rows",
]
