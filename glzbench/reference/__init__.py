"""The plain references the benchmark judges the program's outputs by, one
module a reference, named by the configurations' `reference` key.  They
import nothing of the program."""
