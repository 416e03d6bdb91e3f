"""Deploy options given in a configuration as plain data, one module an
option name: ``options/<name>.py`` defines ``make(value)``, the program's
type of the option. An option with no module is passed as it is.
"""
